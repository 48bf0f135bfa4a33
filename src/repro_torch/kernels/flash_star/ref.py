"""Plain PyTorch version of the flash_star kernel (heads-major layout).

The same online form the kernel computes — a loop over KV blocks carrying
the int32 grid max, the denominator and the accumulator — through
``core.attention.blocked_attention``; with ``pv_int8`` the P.V product of
each ``block_k`` block in int8 as the kernel's variant computes it.
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
