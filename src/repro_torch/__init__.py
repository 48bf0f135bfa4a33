"""``repro_torch`` — the PyTorch / NVIDIA H100 port of the STAR reproduction.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``core/``, ``ops/``, ``kernels/<name>/``, ``configs/``,
``models/``, ``serve/``, ``launch/``) so each module has an obvious
counterpart, and imports neither ``jax`` nor anything of ``repro``.

Entry points run on the card unless the caller passes ``device="cpu"``
(``ops.platform.resolve_device``); on a CPU tensor every kernel wrapper
runs its plain PyTorch version instead of the Hopper kernel.
"""
