from repro_torch.kernels.flash_star.kernel import flash_star_attention  # noqa: F401
