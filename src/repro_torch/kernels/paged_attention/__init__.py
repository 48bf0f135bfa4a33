from repro_torch.kernels.paged_attention.kernel import paged_flash_attention  # noqa: F401
