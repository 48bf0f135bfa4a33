"""The benchmark's plain reference: float32 PyTorch with no kernels, no
cache and no batching.  It imports nothing of the program (``repro_torch``)
nor of the JAX package; the STAR softmax it needs is a frozen copy
(:mod:`reference.star`)."""
