"""The SSD chunk scan of the mamba2 mixer and its CUDA kernel."""

from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: F401
