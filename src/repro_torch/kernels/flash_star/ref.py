"""Plain PyTorch version of the flash_star kernel (heads-major layout).

The same online form the kernel computes — a loop over KV blocks carrying
the int32 grid max, the denominator and the accumulator — through
``core.attention.blocked_attention``; with ``pv_int8`` the P.V product of
each ``block_k`` block in int8 as the kernel's variant computes it.

``split_bf16x3`` is the plain copy of how the bfloat16 kernel splits P
for P.V on the tensor cores without rounding P to bf16.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import SoftmaxConfig, blocked_attention
from repro_torch.core.fixedpoint import FixedPointFormat


def flash_star_ref(
    q: torch.Tensor,  # [B, Hq, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,  # [B, Hkv, Tk, D]
    info: torch.Tensor,  # int32 [1 + B]: [q_offset, kv_valid per batch]
    *,
    fmt: Optional[FixedPointFormat],
    causal: bool = True,
    sliding_window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    block_k: int = 128,
    pv_int8: bool = False,
) -> torch.Tensor:
    softmax = (
        SoftmaxConfig(kind="exact") if fmt is None
        else SoftmaxConfig(kind="star", fmt=fmt)
    )
    out = blocked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        softmax=softmax,
        causal=causal,
        sliding_window=sliding_window,
        q_offset=info[0],
        kv_valid_len=info[1:],
        scale=sm_scale,
        block_size=block_k,
        pv_int8=pv_int8,
    )
    return out.transpose(1, 2)


def split_bf16x3(p: torch.Tensor):
    """float32 ``p`` as three bfloat16 pieces, as the bf16 kernel splits it:
    ``hi = bf16(p)``, ``mid = bf16(p - hi)``, ``lo = bf16((p - hi) - mid)``
    (round to nearest even; both differences are exact in float32).  For
    ``p >= 2**-100`` the pieces sum to ``p`` exactly (each piece holds 8 of
    its 24 significant bits); below that ``lo`` may fall among the bf16
    subnormals and ``|p - (hi + mid + lo)| <= 2**-134``, half their spacing."""
    p = p.float()
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo

