"""STAR softmax — the paper's softmax engine on tensors (port of
``repro.core.star_softmax``).

Pipeline: snap logits to the integer grid, integer row max, codebook index
``k = clip(m - j)``, numerators from the LUT (``gather`` or ``onehot``),
denominator as a row sum or ``histogram(k) @ lut`` (``histogram`` mode).
The three modes agree up to float summation order.

``star_softmax_ste`` (the training VJP) and the ``fault`` argument belong to
later slices of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.fixedpoint import (
    DEFAULT_FORMAT,
    GRID_SENTINEL,
    FixedPointFormat,
    grid_index,
    quantize_logits,
)

Modes = ("gather", "onehot", "histogram")


def exact_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The FP oracle (numerically stable softmax)."""
    return torch.softmax(x, dim=axis)


def star_softmax(
    x: torch.Tensor,
    fmt: FixedPointFormat = DEFAULT_FORMAT,
    *,
    axis: int = -1,
    mode: str = "histogram",
    where: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Quantized LUT softmax along ``axis``.

    ``where`` masks entries out (probability 0, not counted in the
    denominator); fully masked rows come out as zeros.
    """
    if mode not in Modes:
        raise ValueError(f"mode must be one of {Modes}, got {mode!r}")
    out_dtype = dtype or (x.dtype if x.is_floating_point() else torch.float32)
    moved = torch.movedim(x.float(), axis, -1)
    wmask = None
    if where is not None:
        wmask = torch.movedim(torch.broadcast_to(where, x.shape), axis, -1)

    j = quantize_logits(moved, fmt)
    if wmask is not None:
        j = torch.where(wmask, j, torch.full_like(j, GRID_SENTINEL))
    m = j.amax(dim=-1, keepdim=True)
    k = grid_index(j, m, fmt)

    table = lut_lib.exp_lut(fmt, device=x.device)
    if mode == "onehot":
        num = lut_lib.lookup_onehot(k, table)
    else:
        num = lut_lib.lookup_gather(k, table)
    if wmask is not None:
        num = torch.where(wmask, num, torch.zeros_like(num))

    if mode == "histogram":
        onehot = torch.nn.functional.one_hot(k.long(), fmt.num_levels).float()
        if wmask is not None:
            onehot = onehot * wmask.float()[..., None]
        den = lut_lib.histogram_dot(onehot.sum(dim=-2), table)[..., None]
    else:
        den = num.sum(dim=-1, keepdim=True)
    den = torch.where(den <= 0.0, torch.ones_like(den), den)
    return torch.movedim(num / den, -1, axis).to(out_dtype)
