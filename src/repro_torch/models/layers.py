"""Model building blocks (port of ``repro.models.layers``: RMSNorm and
LayerNorm, RoPE, M-RoPE and sinusoidal positions, self- and
cross-attention, the MLP, the MoE block with its STAR router and the causal
depthwise conv of the ssm and hybrid families).

Functional style as in the reference: parameters are dicts of tensors,
layers are functions.  Weights are read through ``.to(compute_dtype)``
where they are used; the engines hand in ``models.param.compute_params``'s
tree, cast once, so those reads copy nothing.  Projections are plain
``torch.matmul``; attention goes through ``repro_torch.ops``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import ops
from repro_torch.core import kvquant
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    conv_on_shards,
    copy_rows_on_shards,
    current_mesh_rules,
    embed_on_shards,
    from_local,
    global_offset,
    is_dtensor,
    local_shard,
    logical_to_pspec,
    matmul_on_shards,
    merge_heads_on_shards,
    placements,
    rows_on_shards,
    take_last_on_shards,
    use_mesh_rules,
    whole_unless_divides,
    write_row_on_shards,
)
from repro_torch.distributed.sharding import with_logical_constraint as wlc
from repro_torch.models.param import ParamSpec

Params = Dict[str, Any]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# norms, embedding


def spec_rmsnorm(cfg: ModelConfig, dim: Optional[int] = None) -> Params:
    return {"scale": ParamSpec((dim or cfg.d_model,), ("embed",), pdtype(cfg), "ones")}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def spec_layernorm(cfg: ModelConfig, dim: Optional[int] = None) -> Params:
    d = dim or cfg.d_model
    return {"scale": ParamSpec((d,), ("embed",), pdtype(cfg), "ones"),
            "bias": ParamSpec((d,), ("embed",), pdtype(cfg), "zeros")}


def layernorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in float32 (biased variance, as
    ``jnp.var``), back in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``.  Under a mesh it runs on each rank's shard
    (``distributed.sharding.matmul_on_shards``): ``x`` keeps its leading
    dims' sharding (the batch, and the rows under sequence parallelism,
    which DTensor's own rule cannot flatten), ``w`` runs column- or
    row-parallel where its sharding allows, and no activation is left a
    partial sum."""
    if is_dtensor(x):
        return matmul_on_shards(x, w)
    return x @ w


def write_rows(dst: torch.Tensor, src: torch.Tensor, dim: Optional[int] = None) -> None:
    """``dst``'s first rows along ``dim`` take ``src``, in place (``dim=None``:
    all of ``dst``, ``src`` of its shape).  A cache placed on a mesh is
    written on its shards (``distributed.sharding.copy_rows_on_shards``)."""
    if is_dtensor(dst):
        copy_rows_on_shards(dst, src, dim)
    elif dim is None:
        dst.copy_(src)
    else:
        dst.narrow(dim, 0, src.shape[dim]).copy_(src)


def spec_embedding(cfg: ModelConfig) -> Params:
    return {"table": ParamSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), pdtype(cfg),
                               "embed")}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather then cast: the same values as casting the whole table first
    if is_dtensor(tokens):  # under a mesh: on each rank's shard
        rows = embed_on_shards(p["table"], tokens)
    else:
        rows = p["table"][tokens.long()]
    return wlc(rows.to(cdtype(cfg)), ("batch", "seq", "embed"))


def spec_unembed(cfg: ModelConfig) -> Params:
    if cfg.tie_embeddings:
        return {}
    return {"kernel": ParamSpec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), pdtype(cfg),
                                "fan_in")}


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig, embed_params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        kernel = embed_params["table"].to(cdtype(cfg)).T
    else:
        kernel = p["kernel"].to(cdtype(cfg))
    logits = linear(x, kernel)
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding columns
        valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits, -1e30)
    return wlc(logits, ("batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[B, T, H, D]`` rotated by positions ``[B, T]`` (half-split)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def mrope_streams(sections: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Which positional stream (t / h / w) drives each frequency of the
    rotary half: stream ``i`` repeated ``sections[i]`` times.  Static, so it
    is made once per device (by the first eager call, before any capture of
    a decode step reads it) and never uploaded again."""
    streams = [i for i, n in enumerate(sections) for _ in range(n)]
    return torch.tensor(streams, dtype=torch.int64, device=device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): x ``[B, T, H, D]`` rotated by positions
    ``[B, T, 3]`` = (t, h, w) ids; ``sections`` splits the half-dim into
    per-stream frequency bands.  Where the three streams are equal, the
    angles (and so the output) are bit for bit ``apply_rope``'s at that
    position: the same float32 product goes through the same cos and sin."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope_sections {tuple(sections)} must sum to head_dim // 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    pos = positions.float().index_select(-1, mrope_streams(tuple(sections), x.device))
    angles = pos * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(t0, length: int, d_model: int, device=None) -> torch.Tensor:
    """The classic sinusoidal table's rows ``[t0, t0 + length)``: ``[length,
    d_model]`` float32, sines then cosines (the enc-dec family).  ``t0`` is
    a Python int or a 0-dim device tensor (a decode step's ``len``: read
    where it lives, so a captured step uploads nothing)."""
    if torch.is_tensor(t0):
        device = t0.device
    pos = (torch.arange(length, device=device) + t0)[:, None].float()
    half = d_model // 2
    step = float(np.float32(np.log(np.float32(10000.0))) / np.float32(half))  # float32, as jnp
    div = torch.exp(-torch.arange(half, dtype=torch.float32, device=device) * step)
    ang = pos * div[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rotate(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
           cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k rotated by ``positions`` ``[B, T]`` or ``[B, T, 3]``, the
    reference's choice: M-RoPE where the config has sections and the
    positions are 3-D; a 3-D position on a config without sections uses its
    stream 0; otherwise ``apply_rope``."""
    if cfg.mrope_sections and positions.ndim == 3:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    if positions.ndim == 3:
        positions = positions[..., 0]
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# attention


def spec_attention(cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    pd = pdtype(cfg)
    p: Params = {
        "wq": ParamSpec((d, hq * hd), ("embed", "heads"), pd),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), pd),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), pd),
        "wo": ParamSpec((hq * hd, d), ("heads", "embed"), pd),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((hq * hd,), ("heads",), pd, "zeros")
        p["bk"] = ParamSpec((hkv * hd,), ("kv_heads",), pd, "zeros")
        p["bv"] = ParamSpec((hkv * hd,), ("kv_heads",), pd, "zeros")
    return p


def _project_qkv(p: Params, x: torch.Tensor, xkv: torch.Tensor, cfg: ModelConfig):
    dt = cdtype(cfg)
    hd = cfg.resolved_head_dim
    q = linear(x, p["wq"].to(dt))
    k = linear(xkv, p["wk"].to(dt))
    v = linear(xkv, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, t, tk = x.shape[0], x.shape[1], xkv.shape[1]
    return (split_heads(q, b, t, cfg.num_heads, hd),
            split_heads(k, b, tk, cfg.num_kv_heads, hd),
            split_heads(v, b, tk, cfg.num_kv_heads, hd))


def merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, D]`` -> ``[B, T, H * D]``; under a mesh on each rank's
    shard (``distributed.sharding.merge_heads_on_shards``), so neither the
    merge nor its gradient goes through DTensor's view rule."""
    if is_dtensor(ctx):
        return merge_heads_on_shards(ctx)
    return ctx.reshape(ctx.shape[0], ctx.shape[1], -1)


def split_heads(x: torch.Tensor, b: int, t: int, heads: int, hd: int) -> torch.Tensor:
    """``[B, T, H * D]`` -> ``[B, T, H, D]``; under a mesh the columns are
    first made whole where their sharding would cut a head."""
    if is_dtensor(x):
        x = whole_unless_divides(x, 2, heads)
    return x.reshape(b, t, heads, hd)


CONFIG_WINDOW = "config"  # attention_block's default window: cfg.sliding_window


def _default_positions(cache: Optional[Params], b: int, tq: int, device) -> torch.Tensor:
    """The reference's positions when none are given: ``len + arange(tq)``
    from the cache's scalar ``len`` (a Python int or a 0-dim device tensor,
    read where it lives), else from 0.  A per-slot pool's ``[S]`` counters
    cannot give them (a VLM's rope position is not its row count)."""
    base = 0 if cache is None else cache["len"]
    if torch.is_tensor(base) and base.ndim == 1:
        raise ValueError("per-slot caches require explicit positions "
                         "(decode_step builds them from the pool's 'pos' counters)")
    pos = base + torch.arange(tq, dtype=torch.int32, device=device)
    return pos[None].expand(b, tq)


def attention_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B, T], or [B, T, 3] (t, h, w) for M-RoPE
    cache: Optional[Params] = None,
    paged_cache_t: Optional[int] = None,
    causal: bool = True,
    sliding_window: Any = CONFIG_WINDOW,
    xkv: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[Params], Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention (causal unless ``causal=False``, as an encoder's) or,
    given ``xkv`` (``[B, Tk, d_model]`` memory), cross-attention: K/V from
    the memory, never causal and without a cache, as in the reference.
    ``sliding_window`` defaults to ``cfg.sliding_window`` (the hybrid passes
    its ``local_window``); ``use_rope=False`` leaves q and k unrotated (the
    enc-dec family adds sinusoidal positions to its inputs instead).
    ``positions`` default to ``len + arange(T)`` of a scalar cache, else
    ``arange(T)``.  The cache comes in these forms:

    * ``cache=None`` — dense prefill (and cross-attention), keys past a
      row's ``kv_valid_len`` ``[B]`` masked (a ragged batch); a cache
      brings its own valid lengths and ignores it;
    * a *scalar-``len``* cache ``{"k", "v", "len"}`` (``[B, T, Hkv, D]``):
      the ``tq`` fresh rows land at ``[len, len + tq)`` and the queries
      attend at ``q_offset = len``, causally, over ``len + tq`` valid rows.
      ``len`` is a Python int for chunked prefill's linear staging cache and
      a 0-dim device tensor for the lockstep decode cache (the write index
      stays on the device);
    * a *scalar ring* (the lockstep cache under a window, ``T <= window``):
      one token at row ``len % T``, then attention over ``min(len + 1, T)``
      rows, unmasked by position;
    * a *per-slot dense* pool (``len`` an ``[S]`` vector): one token per
      slot at its own row ``len`` (a ring: ``len % T``), then attention over
      each slot's ``len + 1`` rows (a ring: ``min(len + 1, T)``);
    * a *paged* cache ``{"k", "v", "len", "tables"}`` (+ ``k_scale`` /
      ``v_scale`` for a quantized pool) — one decode token per slot,
      written at ``(tables[s, idx // bs], idx % bs)``, ``idx`` = ``len`` or,
      on a ring, ``len % paged_cache_t``.

    Cache writes are **in place** (the reference returns new arrays).  A
    quantized pool stores codes: a block's scale is stamped from its first
    row (``row == 0``; on a ring only in the first lap) and later rows reuse
    it with a clipped encode, so a block's codes always decode through the
    scale they were written with.

    Returns ``(out [B, T, Hq*D], cache', (k, v))``."""
    b, tq, _ = x.shape
    window = cfg.sliding_window if sliding_window == CONFIG_WINDOW else sliding_window
    if xkv is not None:
        if cache is not None:
            raise ValueError("cross-attention (xkv) takes no cache")
        q, k, v = _project_qkv(p, x, xkv, cfg)
        ctx = ops.attention(q, k, v, cfg.attention_spec, causal=False, sliding_window=window,
                            kv_valid_len=kv_valid_len)
        return merge_heads(ctx), None, (k, v)
    q, k, v = _project_qkv(p, x, x, cfg)
    if use_rope:
        if positions is None:
            positions = _default_positions(cache, b, tq, x.device)
        q, k = rotate(q, k, positions, cfg)
    if cfg.seq_parallel_activations and tq > 1:
        # heads that do not divide the model dim leave the scores replicated;
        # sharding the q rows over it instead keeps the softmax row-local
        q = wlc(q, ("batch", "act_seq", "heads", None))
    else:
        q = wlc(q, ("batch", "seq", "heads", None))

    if cache is None:
        ctx = ops.attention(q, k, v, cfg.attention_spec, causal=causal, sliding_window=window,
                            kv_valid_len=kv_valid_len)
        return merge_heads(ctx), None, (k, v)
    if "tables" in cache:
        return _paged_decode(q, k, v, cfg, cache, paged_cache_t, window)
    if is_dtensor(cache["k"]):  # a cache placed on a mesh
        return _decode_on_shards(q, k, v, cfg, cache, causal, window)

    ck, cv, ln = cache["k"], cache["v"], cache["len"]
    cache_t = ck.shape[1]
    ring = window is not None and cache_t <= window
    per_slot = torch.is_tensor(ln) and ln.ndim == 1
    if (per_slot or ring) and tq != 1:
        raise ValueError("per-slot and ring caches take one decode token per row")
    if per_slot or ring:
        if isinstance(ln, int):
            ln = torch.tensor(ln, dtype=torch.int32, device=x.device)
        new_len = ln + 1
        idx = ln.long() % cache_t if ring else ln.long()
        if per_slot:
            _write_rows(ck, cv, idx, k[:, 0], v[:, 0])
        else:
            ck.index_copy_(1, idx.reshape(1), k.to(ck.dtype))
            cv.index_copy_(1, idx.reshape(1), v.to(cv.dtype))
        # one token: "attend to the first len + 1 rows" is the causal mask,
        # and a ring holds min(len + 1, T) live rows in slot order
        valid = torch.clamp(new_len, max=cache_t) if ring else new_len
        ctx = ops.attention(q, ck, cv, cfg.attention_spec, causal=False, sliding_window=None,
                            q_offset=0, kv_valid_len=valid.expand(b))
        return merge_heads(ctx), {"k": ck, "v": cv, "len": new_len}, (k, v)

    if isinstance(ln, int):  # linear staging cache (chunked prefill)
        if ln + tq > cache_t:
            raise ValueError(f"staging cache of {cache_t} rows cannot take {tq} rows at {ln}")
        ck[:, ln:ln + tq] = k.to(ck.dtype)
        cv[:, ln:ln + tq] = v.to(cv.dtype)
        valid = torch.full((b,), ln + tq, dtype=torch.int32, device=x.device)
    else:  # the lockstep cache: its device len indexes the write
        rows = ln.long() + torch.arange(tq, device=x.device)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        valid = (ln + tq).expand(b)
    ck = wlc(ck, ("batch", "kv_seq", "kv_heads", None))
    cv = wlc(cv, ("batch", "kv_seq", "kv_heads", None))
    ctx = ops.attention(q, ck, cv, cfg.attention_spec, causal=causal, sliding_window=window,
                        q_offset=ln, kv_valid_len=valid)
    return merge_heads(ctx), {"k": ck, "v": cv, "len": ln + tq}, (k, v)


class MeshCacheError(ValueError):
    """A cache form that the mesh path does not take."""


def _decode_on_shards(q, k, v, cfg: ModelConfig, cache: Params, causal: bool,
                      window: Optional[int]):
    """One decode token over a lockstep cache (or a scalar ring) whose K / V
    are DTensors, their rows split over "kv_seq": the step's K / V row is
    written on the rank whose slice holds row ``len`` (``% T`` on a ring),
    and attention runs on the shards (``ops.attention``: the split softmax
    where the rows are split over more than one rank, else each rank's whole
    rows).  The same masks as the unsharded paths: causal at ``q_offset =
    len`` over ``len + 1`` rows, or a ring's ``min(len + 1, T)`` rows."""
    b, tq = q.shape[0], q.shape[1]
    ck, cv, ln = cache["k"], cache["v"], cache["len"]
    if tq != 1 or isinstance(ln, int) or ln.ndim != 0:
        raise MeshCacheError("a cache placed on a mesh takes one decode token a step over "
                             "a scalar device len (no chunk, no per-slot pool)")
    cache_t = ck.shape[1]
    ring = window is not None and cache_t <= window
    idx = ln.long() % cache_t if ring else ln
    write_row_on_shards(ck, k, idx)
    write_row_on_shards(cv, v, idx)
    new_len = ln + 1
    ck = wlc(ck, ("batch", "kv_seq", "kv_heads", None))
    cv = wlc(cv, ("batch", "kv_seq", "kv_heads", None))
    if ring:
        valid = torch.clamp(new_len, max=cache_t)
        ctx = ops.attention(q, ck, cv, cfg.attention_spec, causal=False, sliding_window=None,
                            q_offset=0, kv_valid_len=valid.expand(b))
    else:
        ctx = ops.attention(q, ck, cv, cfg.attention_spec, causal=causal,
                            sliding_window=window, q_offset=ln, kv_valid_len=new_len.expand(b))
    return merge_heads(ctx), {"k": ck, "v": cv, "len": new_len}, (k, v)


def _write_rows(ck: torch.Tensor, cv: torch.Tensor, idx: torch.Tensor,
                k_row: torch.Tensor, v_row: torch.Tensor) -> None:
    """Per-slot dense write: slot ``s``'s row ``idx[s]`` takes its fresh K/V
    row, in place.  A free slot's counters keep growing (the scheduler, not
    ``len``, owns occupancy), so ``idx`` may pass the pool's rows: such a
    write is dropped, as the reference's one-hot hit mask drops it — the
    index is clamped into range and the old row written back."""
    cache_t = ck.shape[1]
    slots = torch.arange(ck.shape[0], device=ck.device)
    safe = torch.clamp(idx, max=cache_t - 1)
    live = (idx < cache_t)[:, None, None]
    for pool, row in ((ck, k_row), (cv, v_row)):
        pool[slots, safe] = torch.where(live, row.to(pool.dtype), pool[slots, safe])


def _paged_decode(q, k, v, cfg: ModelConfig, cache: Params, paged_cache_t: Optional[int],
                  window: Optional[int]):
    b, tq = q.shape[0], q.shape[1]
    if tq != 1 or paged_cache_t is None:
        raise ValueError("the paged cache takes one decode token per slot and paged_cache_t")
    cache_t = paged_cache_t
    ring = window is not None and cache_t <= window
    ck, cv, tables = cache["k"], cache["v"], cache["tables"]
    bs = ck.shape[1]
    idx = cache["len"].long() % cache_t if ring else cache["len"].long()
    # free slots' counters regrow past their (scratch-only) tables; the
    # clamp keeps the gather in range, their writes land in scratch
    col = torch.clamp(idx // bs, 0, tables.shape[1] - 1)
    blk = tables.gather(1, col[:, None])[:, 0].long()
    row = idx % bs
    new_len = cache["len"] + 1
    kv_dtype = kvquant.dtype_of(ck.dtype)
    kv_scales = None
    if kv_dtype != "fp32":
        ks_pages, vs_pages = cache["k_scale"], cache["v_scale"]
        fresh = row == 0
        if ring:  # a later lap's rows decode through the first lap's stamp
            fresh = fresh & (cache["len"] < cache_t)
        fresh = fresh[:, None]
        for rows_f32, pages, scales in ((k[:, 0].float(), ck, ks_pages),
                                        (v[:, 0].float(), cv, vs_pages)):
            sc = torch.where(fresh, kvquant.row_scale(rows_f32, kv_dtype), scales[blk])
            codes = kvquant.encode(rows_f32, sc[..., None], kv_dtype)
            kvquant.indexable(pages)[blk, row] = kvquant.indexable(codes)
            scales[blk] = sc
        kv_scales = (ks_pages, vs_pages)
    else:
        ck[blk, row] = k[:, 0].to(ck.dtype)
        cv[blk, row] = v[:, 0].to(cv.dtype)
    valid = torch.clamp(new_len, max=cache_t) if ring else new_len
    spec = dataclasses.replace(cfg.paged_attention_spec, block_size=bs, kv_dtype=kv_dtype)
    ctx = ops.paged_attention(q, ck, cv, tables, spec, kv_valid_len=valid,
                              kv_len=cache_t, kv_scales=kv_scales)
    new_cache = {"k": ck, "v": cv, "len": new_len}
    if kv_scales is not None:
        new_cache["k_scale"], new_cache["v_scale"] = kv_scales
    return merge_heads(ctx), new_cache, (k, v)


def fit_window_cache(k: torch.Tensor, v: torch.Tensor, seq_axis: int, wlen: int,
                     seq_len: int):
    """Trim prefill K/V to a ``wlen``-row cache with slot = position %
    ``wlen`` (port of the reference's ``layers.fit_window_cache``).  Decode
    writes at ``len % wlen``, so the kept window is *rolled* so that token
    ``j`` sits at slot ``j % wlen``; a prompt shorter than ``wlen`` is
    zero-padded."""
    seq = k.shape[seq_axis]
    assert seq == seq_len
    if seq >= wlen:
        kk, vv = k.narrow(seq_axis, seq - wlen, wlen), v.narrow(seq_axis, seq - wlen, wlen)
        shift = (seq_len - wlen) % wlen
        return roll_rows(kk, shift, seq_axis), roll_rows(vv, shift, seq_axis)
    return pad_rows(k, 0, wlen - seq, seq_axis), pad_rows(v, 0, wlen - seq, seq_axis)


def pad_rows(x: torch.Tensor, before: int, after: int, dim: int = 1) -> torch.Tensor:
    """``x`` zero-padded along ``dim``; under a mesh on each rank's shard
    (``distributed.sharding.rows_on_shards``)."""
    pad = [0, 0] * (x.ndim - 1 - dim) + [before, after]
    if is_dtensor(x):
        return rows_on_shards(lambda t: torch.nn.functional.pad(t, pad), x, dim,
                              x.shape[dim] + before + after)
    return torch.nn.functional.pad(x, pad)


def roll_rows(x: torch.Tensor, shift: int, dim: int = 1) -> torch.Tensor:
    """``torch.roll`` along ``dim``; under a mesh on each rank's shard."""
    if is_dtensor(x):
        return rows_on_shards(lambda t: torch.roll(t, shift, dims=dim), x, dim, x.shape[dim])
    return torch.roll(x, shift, dims=dim)


def attention_out(p: Params, ctx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return wlc(linear(ctx, p["wo"].to(cdtype(cfg))), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# MLP


def spec_mlp(cfg: ModelConfig, d_ff: Optional[int] = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = pdtype(cfg)
    if cfg.mlp_type == "swiglu":
        return {"wi": ParamSpec((d, f), ("embed", "mlp"), pd),
                "wg": ParamSpec((d, f), ("embed", "mlp"), pd),
                "wo": ParamSpec((f, d), ("mlp", "embed"), pd)}
    return {"wi": ParamSpec((d, f), ("embed", "mlp"), pd),
            "wo": ParamSpec((f, d), ("mlp", "embed"), pd)}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    h = linear(x, p["wi"].to(dt))
    if cfg.mlp_type == "swiglu":
        h = torch.nn.functional.silu(linear(x, p["wg"].to(dt))) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")  # jax.nn.gelu default
    h = wlc(h, ("batch", "seq", "mlp"))
    return wlc(linear(h, p["wo"].to(dt)), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# MoE (granite-moe: 32 experts; mixtral: 8)


def spec_moe(cfg: ModelConfig) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pd = pdtype(cfg)
    return {"router": ParamSpec((d, e), ("embed", None), pd),
            "wi": ParamSpec((e, d, f), ("expert", "embed", "mlp"), pd),
            "wg": ParamSpec((e, d, f), ("expert", "embed", "mlp"), pd),
            "wo": ParamSpec((e, f, d), ("expert", "mlp", "embed"), pd)}


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Per-expert queue capacity of a ``tokens_per_group``-token call.  A
    chunked prefill passes the capacity of the whole prompt into every chunk
    (with the carried queue counts, ``moe(state=...)``), so its drops are
    those of one monolithic prefill."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * tokens_per_group / cfg.num_experts))


def router_spec(cfg: ModelConfig) -> ops.SoftmaxSpec:
    """The router's softmax: the config's spec (the STAR engine), its exact
    oracle when ``star_router`` is off; an exact router goes to the
    ``reference`` impl, since the kernel backend is STAR only."""
    spec = cfg.softmax_spec
    if not cfg.star_router:
        spec = dataclasses.replace(spec, kind="exact")
    if spec.kind == "exact":
        spec = dataclasses.replace(spec, impl="reference")
    return spec


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, ties to
    the lower index (``jax.lax.top_k``'s order; ``torch.topk`` breaks ties
    otherwise, and quantized STAR probabilities tie often)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes by comparison with an
    ``arange``: an index outside ``[0, n)`` is a zero row (as
    ``jax.nn.one_hot``), with no range check read back to the host."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
):
    """Grouped one-hot dispatch MoE (GShard-style, capacity-dropped); one
    group per batch row.  The router softmax goes through ``ops.softmax``
    with ``router_spec(cfg)``: the STAR engine (the kernel under
    ``impl="pallas"``).

    ``state`` (``[groups, experts]`` int32: the per-expert counts of earlier
    chunks of the same sequences) and ``capacity`` (the whole sequence's)
    make the drops chunk-invariant: every (token, choice) takes its global
    queue position.  Given either, the call returns ``(y, new_state)``,
    whose counts include dropped choices; the bare form returns ``y``.

    The dense products (dispatch, the experts, combine) are the reference's
    einsums.  Every step stays on the device: the one-hots compare against
    an ``arange`` and nothing is read back, so a CUDA graph captures it.

    Under a mesh (``x`` a DTensor) the block runs expert-parallel on each
    rank's shard (:func:`_moe_on_shards`), the bare form only."""
    if is_dtensor(x):
        if state is not None or capacity is not None:
            raise ValueError("under a mesh the MoE block runs bare (no state or capacity): "
                             "chunked serving is not sharded")
        return _moe_on_shards(p, x, cfg)
    return _moe(p, x, cfg, state=state, capacity=capacity)


def _moe(p: Params, x: torch.Tensor, cfg: ModelConfig, *, state=None, capacity=None,
         span: Optional[Tuple[int, int]] = None):
    """:func:`moe` on plain tensors.  ``span`` ``(e0, n)``: ``p``'s experts
    are experts ``[e0, e0 + n)`` of the router's, and the result is their
    part of the output (a partial sum over the experts' shards)."""
    dt = cdtype(cfg)
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    groups, tg = b, t
    xg = x.reshape(groups, tg, d)
    stateful = state is not None or capacity is not None

    logits = (xg @ p["router"].to(dt)).float()
    probs = ops.softmax(logits, router_spec(cfg))
    gate_vals, gate_idx = top_k(probs, k)  # [g, t, k]
    total = gate_vals[..., 0]
    for i in range(1, k):  # the reference's order of the sum over k
        total = total + gate_vals[..., i]
    gate_vals = gate_vals / torch.clamp(total, min=1e-9)[..., None]

    cap = capacity if capacity is not None else moe_capacity(cfg, tg)
    # each (token, choice)'s position in its expert's queue
    onehot = _one_hot(gate_idx, e)  # [g, t, k, e]
    flat = onehot.reshape(groups, tg * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(groups, tg, k, e)
    if state is not None:  # offset by the earlier chunks' counts: global positions
        pos = pos + state.float()[:, None, None, :]
    pos = (pos * onehot).sum(dim=-1)  # [g, t, k]
    keep = pos < cap
    gate_vals = gate_vals * keep

    pos_oh = _one_hot(pos.long(), cap)  # [g, t, k, cap]: a dropped choice is a zero row
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None], pos_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", onehot, pos_oh, gate_vals)
    if span is not None:  # this rank's experts
        dispatch = dispatch[:, :, span[0]:span[0] + span[1]]
        combine = combine[:, :, span[0]:span[0] + span[1]]

    xin = torch.einsum("gtec,gtd->egcd", dispatch, xg.float()).to(dt)
    xin = wlc(xin, ("expert", "batch", None, "embed"))
    h = torch.einsum("egcd,edf->egcf", xin, p["wi"].to(dt))
    g_ = torch.einsum("egcd,edf->egcf", xin, p["wg"].to(dt))
    h = torch.nn.functional.silu(g_) * h
    h = wlc(h, ("expert", "batch", None, "mlp"))
    out = torch.einsum("egcf,efd->egcd", h, p["wo"].to(dt))
    out = wlc(out, ("expert", "batch", None, "embed"))
    y = torch.einsum("gtec,egcd->gtd", combine.to(dt), out)
    y = wlc(y.reshape(b, t, d), ("batch", "seq", "embed"))
    if not stateful:
        return y
    counts = onehot.sum(dim=(1, 2)).to(torch.int32)  # [g, e], dropped choices included
    return y, counts if state is None else state + counts


def _moe_on_shards(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE block expert-parallel on every rank's shard.  The rules place
    the batch (groups) and the experts on mesh dims; each rank takes its
    groups' tokens whole, the router whole and its experts' weights whole
    along ``embed`` / ``mlp``, routes its tokens over all experts, runs only
    its own, and returns its part of ``y``: a partial sum over the experts'
    mesh dims, which the ``("batch", "seq", "embed")`` constraint reduces.
    The gradients' placements say the same: a rank's routing and token
    gradients are partial over the experts' dims (and the router's and the
    experts' over the batch's)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, rules = current_mesh_rules()
    # which mesh dims the rules give the groups (Shard(0)) and the experts (Shard(1))
    where = placements(logical_to_pspec(("batch", "expert"), (x.shape[0], cfg.num_experts),
                                        rules, mesh), mesh)
    rep, part = Replicate(), Partial()

    def pl(on_batch, on_expert, other):
        return tuple(on_batch if w == Shard(0) else on_expert if w == Shard(1) else other
                     for w in where)

    x_want = pl(Shard(0), rep, rep)
    w_want = pl(rep, Shard(0), rep)
    xl = local_shard(x, x_want, grad=pl(Shard(0), part, rep))
    router = local_shard(p["router"], pl(rep, rep, rep), grad=pl(part, part, rep))
    experts = {k: local_shard(p[k], w_want, grad=pl(part, Shard(0), rep))
               for k in ("wi", "wg", "wo")}
    e0 = global_offset(p["wi"], w_want)[0]
    y = _moe({"router": router, **experts}, xl, cfg, span=(e0, experts["wi"].shape[0]))
    y = from_local(y, mesh, pl(Shard(0), part, rep), x.shape)
    return wlc(y, ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# causal depthwise conv (mamba2)


def spec_conv1d(cfg: ModelConfig, channels: int, width: int) -> Params:
    return {"kernel": ParamSpec((width, channels), ("conv", "mlp"), pdtype(cfg), "fan_in")}


def causal_conv1d(
    p: Params, x: torch.Tensor, state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv.  x ``[B, T, C]``; ``state`` ``[B, W-1, C]``
    carries the context for decode.  Returns ``(y, new_state)``: without a
    state, ``new_state`` is None; with one, the last ``W-1`` input rows."""
    if is_dtensor(x) and state is None:  # under a mesh: on each rank's shard
        return conv_on_shards(lambda w, xl: causal_conv1d({"kernel": w}, xl)[0],
                              p["kernel"], x), None
    w = p["kernel"].to(x.dtype)  # [W, C]
    width = w.shape[0]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
        new_state = None
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xp[:, -(width - 1):, :]
    t = xp.shape[1] - (width - 1)
    y = xp[:, 0:t, :] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + t, :] * w[i]
    return y, new_state


# ---------------------------------------------------------------------------
# training


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; with ``cfg.remat`` and grad mode on, its activations
    are not kept but recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` of each block.  The same operations run again on the
    same inputs, so the loss and every gradient are bit for bit those
    without it.  The recomputation runs under the mesh and rules of the
    forward: the backward of a card's tensors runs on autograd's own
    thread, which does not see the forward thread's ``use_mesh_rules``."""
    if cfg.remat and torch.is_grad_enabled():
        state = current_mesh_rules()
        if state is not None:
            inner = fn

            def fn(*a):
                with use_mesh_rules(*state):
                    return inner(*a)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)



def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over positions with ``label >= 0`` (float32
    reductions).  Under a mesh the vocab dim is made whole first: the
    labels' gather reads any column, on each rank's shard
    (``distributed.sharding.take_last_on_shards``: DTensor's own gather
    backward fills a zero gradient of the *global* logits' size on every
    rank)."""
    lg = wlc(logits.float(), ("batch", "seq", None))
    m = lg.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(lg - m).sum(dim=-1))
    idx = labels.clamp(min=0).long()
    if is_dtensor(lg):
        picked = take_last_on_shards(lg, idx)
    else:
        picked = lg.gather(-1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp(min=1.0)
