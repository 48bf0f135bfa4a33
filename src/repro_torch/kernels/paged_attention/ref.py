"""Plain PyTorch version of the paged decode kernel: the gather adapter.

Gathers every slot's table window into a dense ``[S, W*bs, Hkv, D]`` view
(logical row ``i`` lives at ``(table[i // bs], i % bs)``), dequantizing a
quantized pool's codes through each block's own scale row
(``kvquant.decode``), and runs whole-operand attention over the ragged
valid prefix — the reference's ``impls._gather_pages`` + ``attention``
path.  The kernel never builds this view; the plain version exists to hold
it to.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kvquant
from repro_torch.core.attention import SoftmaxConfig, attention
from repro_torch.core.fixedpoint import FixedPointFormat


def _take(pages: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    return kvquant.indexable(pages)[flat].view(pages.dtype)


def gather_pages(
    k_pages: torch.Tensor,  # [N, bs, Hkv, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, W] int32
    kv_len: Optional[int] = None,
    kv_scales: Optional[tuple] = None,  # (k_scale, v_scale), each [N, Hkv] f32
):
    """Dense ``[S, kv_len or W*bs, Hkv, D]`` K/V views of each slot's table
    (float32 values when ``kv_scales`` dequantizes the codes)."""
    s, w = block_tables.shape
    _, bs, hkv, d = k_pages.shape
    flat = block_tables.reshape(-1).long()
    kd, vd = _take(k_pages, flat), _take(v_pages, flat)
    if kv_scales is not None:
        k_scale, v_scale = kv_scales
        kd = kvquant.decode(kd, k_scale[flat][:, None, :, None])
        vd = kvquant.decode(vd, v_scale[flat][:, None, :, None])
    kd = kd.reshape(s, w * bs, hkv, d)
    vd = vd.reshape(s, w * bs, hkv, d)
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
    k_scale: Optional[torch.Tensor] = None,  # [N, Hkv] f32: quantized pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    scales = None if k_scale is None else (k_scale, v_scale)
    kd, vd = gather_pages(k_pages, v_pages, block_tables, kv_scales=scales)
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
