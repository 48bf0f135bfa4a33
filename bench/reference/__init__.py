"""The benchmark's plain references: float32 PyTorch with no kernels, no
cache and no batching, one module an architecture, which a configuration
names under ``"reference"`` (the contract: :mod:`reference.common`).  They
import nothing of the program (``repro_torch``) nor of the JAX package; the
STAR softmax they need is a frozen copy (:mod:`reference.star`)."""
