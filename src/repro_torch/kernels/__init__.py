"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each ``kernels/<name>/kernel.py`` holds the wrapper a caller uses: on a CUDA
tensor it launches the kernel (CUDA C++ built by ``nvcc`` for ``sm_90a``)
and adds one to its launch counter; on a CPU tensor it runs the
plain PyTorch version beside it.  ``launch_counts`` / ``reset_launch_counts``
read and clear every counter (``chip_smoke.py`` uses them to show that the
main path went through the kernels).
"""

from repro_torch.kernels._cuda import launch_counts, reset_launch_counts  # noqa: F401
