"""Attention with a pluggable softmax engine (port of ``repro.core.attention``).

* :func:`attention` materializes the score matrix.
* :func:`blocked_attention` is the vector-grained pipeline: an online
  softmax over KV blocks.  Under STAR arithmetic the running max is an int32
  grid index and the rescale factor a LUT entry, so it equals the two-pass
  engine to float32 rounding while ``lut[a] * lut[b] == lut[a + b]``, i.e.
  while no rescale and probability index sum past the table's deepest
  level, where it clamps.  Past it (formats whose last entry is not
  negligible: 2 to 5 bits, ``lut.clamp_is_negligible``) the result depends
  on ``block_size``, as the TPU kernels' does on their blocks.

Both are the plain versions behind the ``flash_star`` kernel.  Layout:
q ``[B, Tq, Hq, D]``, k/v ``[B, Tk, Hkv, D]`` (GQA: head ``h`` reads KV head
``h // (Hq // Hkv)``), output ``[B, Tq, Hq, D]`` in q's dtype.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.core.star_softmax import exact_softmax, star_softmax, star_softmax_ste
from repro_torch.hwmodel.faults import FaultModel, is_null

NEG_INF = -1e30  # finite mask value: keeps the index math NaN-free


@dataclasses.dataclass(frozen=True)
class SoftmaxConfig:
    """Which softmax engine attention uses: ``exact`` (the FP oracle),
    ``star`` (the quantized LUT) or ``star_ste`` (the quantized forward with
    a straight-through backward, in :func:`attention` only:
    :func:`blocked_attention` runs the integer-grid form for both STAR
    kinds, as the reference does, so Q and K get no gradient there)."""

    kind: str = "star"
    fmt: FixedPointFormat = DEFAULT_FORMAT
    mode: str = "gather"
    fault: Optional[FaultModel] = None  # device non-idealities of the STAR arrays

    def __post_init__(self):
        if self.kind not in ("exact", "star", "star_ste"):
            raise ValueError(f"unknown softmax kind {self.kind!r}")

    @classmethod
    def from_spec(cls, spec) -> "SoftmaxConfig":
        if spec.kind == "exact":
            return cls(kind="exact")
        return cls(kind=spec.kind, fmt=spec.fmt, mode=spec.mode, fault=spec.fault)

    def apply(self, scores: torch.Tensor, where: Optional[torch.Tensor] = None, across=None):
        """``across`` (``.max`` / ``.sum`` over ranks) splits each row over
        ranks that hold a slice of it; see :func:`star_softmax`."""
        if self.kind == "exact":
            if where is not None:
                scores = torch.where(where, scores, torch.full_like(scores, NEG_INF))
            return exact_softmax(scores, axis=-1, across=across)
        if self.kind == "star_ste":
            if where is not None:  # NEG_INF quantizes to the deepest LUT row
                scores = torch.where(where, scores, torch.full_like(scores, NEG_INF))
            return star_softmax_ste(scores, self.fmt, -1, self.mode, self.fault, across)
        return star_softmax(scores, self.fmt, axis=-1, mode=self.mode, where=where,
                            fault=self.fault, across=across)


STAR_SOFTMAX = SoftmaxConfig(kind="star")


def _as_long(x, device):
    """A tensor index as int64 on ``device``; a Python int stays a scalar
    (no host-to-device copy, which a CUDA graph could not capture)."""
    return x if isinstance(x, int) else torch.as_tensor(x, device=device).long()


def _build_mask(
    q_len: int,
    kv_len: int,
    *,
    causal: bool,
    sliding_window: Optional[int],
    q_offset=0,
    kv_valid_len: Optional[torch.Tensor] = None,
    device=None,
    kv_offset: int = 0,
) -> Optional[torch.Tensor]:
    """Boolean ``[Tq, Tk]`` or ``[B, Tq, Tk]`` mask; True = attend.  The
    keys are columns ``kv_offset ..`` of the whole row."""
    rows = torch.arange(q_len, device=device)[:, None] + _as_long(q_offset, device)
    cols = kv_offset + torch.arange(kv_len, device=device)[None, :]
    mask = None
    if causal:
        mask = cols <= rows
    if sliding_window is not None:
        w = cols > rows - sliding_window
        mask = w if mask is None else (mask & w)
    if kv_valid_len is not None:
        valid = cols[None] < _as_long(kv_valid_len, device)[:, None, None]
        mask = valid if mask is None else (mask[None] & valid)
    return mask


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    softmax: SoftmaxConfig = STAR_SOFTMAX,
    causal: bool = False,
    sliding_window: Optional[int] = None,
    q_offset=0,
    kv_valid_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    kv_offset: int = 0,
    across=None,
) -> torch.Tensor:
    """Whole-operand attention (scores materialized).

    Under a mesh, k / v may be one rank's slice of the keys, starting at
    column ``kv_offset`` of the whole row; ``across`` (``.max`` / ``.sum``
    over the ranks that hold the other slices) then combines the softmax's
    row max and denominator and the P.V sum, so every rank gets the whole
    row's output."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qg = q.float().reshape(b, tq, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = _build_mask(
        tq, tk, causal=causal, sliding_window=sliding_window,
        q_offset=q_offset, kv_valid_len=kv_valid_len, device=q.device, kv_offset=kv_offset,
    )
    where = None
    if mask is not None:
        where = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    probs = softmax.apply(scores, where=where, across=across)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    if across is not None:
        out = across.sum(out)
    return out.reshape(b, tq, hq, d).to(q.dtype)


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    softmax: SoftmaxConfig = STAR_SOFTMAX,
    causal: bool = False,
    sliding_window: Optional[int] = None,
    q_offset=0,
    kv_valid_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_size: int = 512,
    pv_int8: bool = False,
) -> torch.Tensor:
    """Online blocked attention: a Python loop over KV blocks carrying the
    running (max, denominator, accumulator).  Refuses a fault: the online
    rescale identity ``lut[a] * lut[b] == lut[a + b]`` does not hold for a
    faulty LUT, so the pipeline would model no physical engine.

    ``pv_int8`` is the flash_star kernel's int8 P.V: per KV block, P as
    ``round(127 p)`` and V as ``round(v * (127 / vamax))`` with ``vamax`` the
    block's absmax over every row and feature (rows past the valid length
    included), floored at 1e-6; the integer products sum exactly (in
    float64) and rescale by ``vamax / 127^2``.  The denominator sums the
    unquantized p."""
    if not is_null(softmax.fault):
        raise ValueError(
            "blocked_attention cannot inject cell faults: the online rescale "
            "identity lut[a] * lut[b] == lut[a + b] does not hold for a faulty LUT. "
            "Use the whole-operand attention() (the dispatch layer routes faulty "
            "specs there)."
        )
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = d ** -0.5 if scale is None else scale
    star = softmax.kind in ("star", "star_ste")
    fmt = softmax.fmt
    table = lut_lib.exp_lut(fmt, device=dev) if star else None
    qg = q.float().reshape(b, tq, hkv, g, d)
    rows = torch.arange(tq, device=dev)[:, None] + _as_long(q_offset, dev)
    valid = None if kv_valid_len is None else _as_long(kv_valid_len, dev)

    if star:
        m = torch.full((b, hkv, g, tq), GRID_SENTINEL, dtype=torch.int32, device=dev)
    else:
        m = torch.full((b, hkv, g, tq), NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((b, hkv, g, tq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, hkv, g, tq, d), dtype=torch.float32, device=dev)
    for c0 in range(0, tk, block_size):
        kb = k[:, c0:c0 + block_size].float()
        vb = v[:, c0:c0 + block_size].float()
        cols = c0 + torch.arange(kb.shape[1], device=dev)[None, :]
        sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * scale
        mask = torch.ones((tq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= cols <= rows
        if sliding_window is not None:
            mask &= cols > rows - sliding_window
        maskb = torch.broadcast_to(mask, sc.shape)
        if valid is not None:
            maskb = maskb & (cols[0] < valid[:, None])[:, None, None, None, :]
        if star:
            jg = torch.where(maskb, quantize_logits(sc, fmt),
                             torch.full_like(sc, GRID_SENTINEL, dtype=torch.int32))
            m_new = torch.maximum(m, jg.amax(dim=-1))
            r = lut_lib.lookup_gather(grid_index(m, m_new, fmt), table)  # clip(m_new - m)
            p = lut_lib.lookup_gather(grid_index(jg, m_new[..., None], fmt), table)
        else:
            sc = torch.where(maskb, sc, torch.full_like(sc, NEG_INF))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            # minimum, not clamp: at m == m_new it splits the gradient as jnp.minimum
            r = torch.exp(torch.minimum(m - m_new, torch.zeros_like(m)))
            p = torch.exp(sc - m_new[..., None])
        p = torch.where(maskb, p, torch.zeros_like(p))
        s = s * r + p.sum(dim=-1)
        if pv_int8:
            vamax = vb.abs().amax(dim=(1, 3)).clamp(min=1e-6)  # [B, Hkv]
            # IEEE divisions, tensor by tensor: torch turns ``127.0 / t`` into
            # ``t.reciprocal() * 127`` and, on CUDA, ``t / 16129.0`` into a
            # multiply by the scalar's reciprocal; either can move a code
            # across a rounding tie
            vq = torch.full_like(vamax, 127.0) / vamax
            v8 = torch.round(vb * vq[:, None, :, None])
            # |sum| <= 128 * 127 * 127 < 2^53: exact in float64 in any order
            pv32 = torch.einsum("bhgqk,bkhd->bhgqd", torch.round(p * 127.0).double(),
                                v8.double()).float()
            pv = pv32 * (vamax / torch.full_like(vamax, 16129.0))[:, :, None, None, None]
        else:
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        o = o * r[..., None] + pv
        m = m_new
    s = torch.where(s <= 0.0, torch.ones_like(s), s)
    out = (o / s[..., None]).permute(0, 3, 1, 2, 4)  # [B, Tq, Hkv, G, D]
    return out.reshape(b, tq, hq, d).to(q.dtype)
