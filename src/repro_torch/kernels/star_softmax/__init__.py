from repro_torch.kernels.star_softmax.kernel import star_softmax_kernel  # noqa: F401
