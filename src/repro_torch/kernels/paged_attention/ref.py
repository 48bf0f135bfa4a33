"""Plain PyTorch version of the paged decode kernel: the gather adapter.

Gathers every slot's table window into a dense ``[S, W*bs, Hkv, D]`` view
(logical row ``i`` lives at ``(table[i // bs], i % bs)``) and runs
whole-operand attention over the ragged valid prefix — the reference's
``impls._gather_pages`` + ``attention`` path.  The kernel never builds
this view; the plain version exists to hold it to.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import SoftmaxConfig, attention
from repro_torch.core.fixedpoint import FixedPointFormat


def gather_pages(
    k_pages: torch.Tensor,  # [N, bs, Hkv, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, W] int32
    kv_len: Optional[int] = None,
):
    """Dense ``[S, kv_len or W*bs, Hkv, D]`` K/V views of each slot's table."""
    s, w = block_tables.shape
    _, bs, hkv, d = k_pages.shape
    flat = block_tables.reshape(-1).long()
    kd = k_pages[flat].reshape(s, w * bs, hkv, d)
    vd = v_pages[flat].reshape(s, w * bs, hkv, d)
    if kv_len is not None and kv_len < w * bs:
        kd, vd = kd[:, :kv_len], vd[:, :kv_len]
    return kd, vd


def paged_attention_ref(
    q: torch.Tensor,  # [S, Hq, D]
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    kv_valid: torch.Tensor,  # [S] int32
    *,
    fmt: Optional[FixedPointFormat],
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    kd, vd = gather_pages(k_pages, v_pages, block_tables)
    softmax = (
        SoftmaxConfig(kind="exact") if fmt is None
        else SoftmaxConfig(kind="star", fmt=fmt)
    )
    out = attention(
        q[:, None], kd, vd, softmax=softmax, causal=False,
        kv_valid_len=kv_valid, scale=sm_scale,
    )[:, 0]
    # a free slot (nothing valid) emits zeros, as the kernel does; the exact
    # softmax of an all-masked row would otherwise spread evenly
    return torch.where((kv_valid > 0)[:, None, None], out, torch.zeros_like(out))
