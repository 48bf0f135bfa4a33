"""A frozen copy of the STAR softmax, the paper's quantized LUT softmax, in
``gather`` mode: logits snap onto the integer grid ``round(x * 2**frac)``
(half to even), the row max is taken on that grid, each entry's codebook
index is ``k = clip(m - j, 0, 2**bits - 1)`` and its numerator the LUT entry
``exp(-k / 2**frac)`` (computed in float64, rounded once to float32); the
denominator is the row's sum.  Masked entries get probability 0 and count
in no sum."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

GRID_SENTINEL = -(1 << 24)  # a masked entry's grid value: always clips to the last level


def exp_lut(int_bits: int, frac_bits: int, device) -> torch.Tensor:
    levels = 1 << (int_bits + frac_bits)
    k = np.arange(levels, dtype=np.float64)
    return torch.from_numpy(np.exp(-k / (1 << frac_bits)).astype(np.float32)).to(device)


def grid_index(x: torch.Tensor, int_bits: int, frac_bits: int,
               where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each entry's codebook index along the last axis (int64)."""
    j = torch.round(x.float() * float(1 << frac_bits))
    j = torch.nan_to_num(j, nan=float(GRID_SENTINEL))
    j = torch.clamp(j, float(GRID_SENTINEL), float(-GRID_SENTINEL)).to(torch.int64)
    if where is not None:
        j = torch.where(where, j, torch.full_like(j, GRID_SENTINEL))
    m = j.amax(dim=-1, keepdim=True)
    return torch.clamp(m - j, 0, (1 << (int_bits + frac_bits)) - 1)


def star_softmax(x: torch.Tensor, int_bits: int, frac_bits: int,
                 where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """STAR softmax over the last axis of ``x``, float32."""
    k = grid_index(x, int_bits, frac_bits, where)
    num = exp_lut(int_bits, frac_bits, x.device)[k]
    if where is not None:
        num = torch.where(where, num, torch.zeros_like(num))
    den = num.sum(dim=-1, keepdim=True)
    den = torch.where(den <= 0.0, torch.ones_like(den), den)
    return num / den
