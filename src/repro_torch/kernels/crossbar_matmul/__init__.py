"""The crossbar MatMul engine model and its CUDA kernel."""
