"""STAR row softmax — the wrapper of the Triton kernel
``triton_kernel.star_softmax_rows`` (port of
``repro.kernels.star_softmax.kernel.star_softmax_pallas``, ``gather`` mode).

Softmax over the last axis of ``x`` (any leading shape), float32 output.
Per row: snap to the int grid, integer row max, ``k = clip(m - j, 0, L-1)``,
``p = lut[k]``, ``den`` = the row sum of ``p``.  Non-finite input saturates
as ``core.fixedpoint.quantize_logits`` does, so a ``-inf`` column gets the
last level's probability (the reference semantics), never level 0.

On a CPU tensor the plain version (``core.star_softmax``) runs instead.
The ``onehot`` / ``histogram`` modes wait for their own port.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.core.star_softmax import star_softmax
from repro_torch.kernels import _cuda

BLOCK = 4096
NUM_WARPS = 8
DTYPES = (torch.float32, torch.bfloat16)
LAUNCHES = _cuda.launch_counter("star_softmax")


def star_softmax_ref(x: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """The plain version: the reference engine in ``gather`` mode."""
    return star_softmax(x, fmt, mode="gather", dtype=torch.float32)


def star_softmax_kernel(
    x: torch.Tensor, fmt: FixedPointFormat, *, mode: str = "gather"
) -> torch.Tensor:
    """STAR softmax over the last axis; float32 ``[..., d]``."""
    if mode != "gather":
        from repro_torch.ops.registry import CapabilityError

        raise CapabilityError(
            f"star_softmax kernel: mode {mode!r} is not ported yet (gather only)"
        )
    if not _cuda.on_card(x):
        return star_softmax_ref(x, fmt)
    return _launch(x, fmt)


def _launch(x: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    from repro_torch.kernels.star_softmax.triton_kernel import star_softmax_rows

    if x.dtype not in DTYPES:
        raise ValueError(f"star_softmax kernel takes float32/bfloat16, got {x.dtype}")
    if x.ndim == 0 or x.shape[-1] == 0:
        raise ValueError(f"star_softmax kernel needs a non-empty last axis, got {tuple(x.shape)}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        raise ValueError("star_softmax kernel needs a contiguous last axis")
    out = torch.empty(x2.shape, dtype=torch.float32, device=x.device)
    lut = _cuda.device_lut(fmt, x.device)
    if x2.shape[0]:
        star_softmax_rows[(x2.shape[0],)](
            x2, out, lut, d, x2.stride(0), out.stride(0), float(fmt.scale),
            TOP=fmt.num_levels - 1, BLOCK=BLOCK, num_warps=NUM_WARPS,
        )
        LAUNCHES.add()
    return out.reshape(x.shape)
