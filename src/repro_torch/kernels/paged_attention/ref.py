"""Plain PyTorch version of the paged decode kernel.

Gathers every slot's table window into a dense ``[S, W*bs, Hkv, D]`` view
(logical row ``i`` lives at ``(table[i // bs], i % bs)``), dequantizing a
quantized pool's codes through each block's own scale row
(``kvquant.decode``), and computes the TPU kernel's function over it, over
the ragged valid prefix.  That kernel runs the online softmax page by page,
and under STAR its result depends on the pages: the identity
``lut[a] * lut[b] == lut[a + b]`` fails once ``a + b`` passes the table's
deepest level ``top``, where it clamps, so at formats whose last entry is
not negligible (2 to 5 bits) it differs from the whole-operand result
(``attention``, which the ``reference`` / ``xla`` paged routes' gather
adapter computes, as the reference's do).  Its weights in closed form: with
``M_p`` the running max after page ``p`` (a prefix max of the pages' grid
maxima), row ``j`` of page ``p`` weighs ``lut[min(M_p - j, top)] * R_p``,
``R_p`` the product of the later pages' rescales ``lut[min(M_p' - M_p'-1,
top)]``; the output is the weighted sum of V over the sum of the weights.
The exact softmax takes no schedule: whole-operand attention.  The kernel
never builds the gathered view; the plain version exists to hold it to.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kvquant
from repro_torch.core.attention import SoftmaxConfig, attention
from repro_torch.core.fixedpoint import GRID_SENTINEL, FixedPointFormat, quantize_logits
from repro_torch.core.lut import exp_lut


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
    if fmt is None:
        out = attention(q[:, None], kd, vd, softmax=SoftmaxConfig(kind="exact"), causal=False,
                        kv_valid_len=kv_valid, scale=sm_scale)[:, 0]
    else:
        out = _paged_star(q, kd, vd, kv_valid, fmt, sm_scale, k_pages.shape[1])
    # a free slot (nothing valid) emits zeros, as the kernel does; the exact
    # softmax of an all-masked row would otherwise spread evenly
    return torch.where((kv_valid > 0)[:, None, None], out, torch.zeros_like(out))


def _paged_star(q, kd, vd, kv_valid, fmt, sm_scale, bs):
    """The TPU kernel's page-by-page STAR softmax in closed form (module
    docstring) over the gathered rows ``kd`` / ``vd`` ``[S, W*bs, Hkv, D]``."""
    s, hq, d = q.shape
    rows, hkv = kd.shape[1], kd.shape[2]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    lut, top = exp_lut(fmt, device=q.device), fmt.num_levels - 1
    qg = q.float().reshape(s, hkv, hq // hkv, d)
    sc = torch.einsum("shgd,sthd->shgt", qg, kd.float()) * scale  # [S, Hkv, G, T]
    live = (torch.arange(rows, device=q.device)[None, :] < kv_valid.long()[:, None])[:, None, None]
    jg = torch.where(live, quantize_logits(sc, fmt), torch.full_like(sc, GRID_SENTINEL,
                                                                     dtype=torch.int32))
    m = torch.cummax(jg.reshape(*jg.shape[:3], rows // bs, bs).amax(-1), dim=-1).values
    # page p + 1's rescale, then R_p = the product of those from page p on
    after = torch.ones_like(m, dtype=torch.float32)
    after[..., :-1] = lut[(m[..., 1:] - m[..., :-1]).clamp(max=top).long()]
    r = torch.flip(torch.cumprod(torch.flip(after, [-1]), dim=-1), [-1])
    page_m = m.repeat_interleave(bs, dim=-1)
    w = lut[(page_m - jg).clamp(0, top).long()] * r.repeat_interleave(bs, dim=-1)
    w = torch.where(live, w, torch.zeros_like(w))
    den = w.sum(-1)
    den = torch.where(den <= 0, torch.ones_like(den), den)
    out = torch.einsum("shgt,sthd->shgd", w, vd.float()) / den[..., None]
    return out.reshape(s, hq, d).to(q.dtype)
