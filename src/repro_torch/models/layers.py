"""Model building blocks (port of ``repro.models.layers``: the dense subset
and the causal depthwise conv of the ssm family).

Functional style as in the reference: parameters are dicts of tensors,
layers are functions.  Weights are read through ``.to(compute_dtype)``
where they are used; the engines hand in ``models.param.compute_params``'s
tree, cast once, so those reads copy nothing.  Projections are plain
``torch.matmul``; attention goes through ``repro_torch.ops``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import ops
from repro_torch.core import kvquant
from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamSpec

Params = Dict[str, Any]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# norms, embedding


def spec_rmsnorm(cfg: ModelConfig) -> Params:
    return {"scale": ParamSpec((cfg.d_model,), pdtype(cfg), "ones")}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def spec_embedding(cfg: ModelConfig) -> Params:
    return {"table": ParamSpec((cfg.padded_vocab, cfg.d_model), pdtype(cfg), "embed")}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather then cast: the same values as casting the whole table first
    return p["table"][tokens.long()].to(cdtype(cfg))


def spec_unembed(cfg: ModelConfig) -> Params:
    if cfg.tie_embeddings:
        return {}
    return {"kernel": ParamSpec((cfg.d_model, cfg.padded_vocab), pdtype(cfg), "fan_in")}


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig, embed_params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        kernel = embed_params["table"].to(cdtype(cfg)).T
    else:
        kernel = p["kernel"].to(cdtype(cfg))
    logits = x @ kernel
    if cfg.padded_vocab != cfg.vocab_size:  # mask padding columns
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# RoPE


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


# ---------------------------------------------------------------------------
# attention


def spec_attention(cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    pd = pdtype(cfg)
    p: Params = {
        "wq": ParamSpec((d, hq * hd), pd),
        "wk": ParamSpec((d, hkv * hd), pd),
        "wv": ParamSpec((d, hkv * hd), pd),
        "wo": ParamSpec((hq * hd, d), pd),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((hq * hd,), pd, "zeros")
        p["bk"] = ParamSpec((hkv * hd,), pd, "zeros")
        p["bv"] = ParamSpec((hkv * hd,), pd, "zeros")
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    dt = cdtype(cfg)
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, t = x.shape[0], x.shape[1]
    return (q.reshape(b, t, cfg.num_heads, hd),
            k.reshape(b, t, cfg.num_kv_heads, hd),
            v.reshape(b, t, cfg.num_kv_heads, hd))


def attention_block(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # [B, T]
    cache: Optional[Params] = None,
    paged_cache_t: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Params], Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention in one of three forms:

    * ``cache=None`` — dense prefill;
    * a *linear staging* cache ``{"k", "v", "len"}`` (``[B, Ts, Hkv, D]``,
      ``len`` a Python int) — chunked prefill: the ``tq`` fresh rows land at
      ``[len, len + tq)`` and the queries attend at ``q_offset = len``,
      causally, over ``len + tq`` valid rows;
    * a *paged* cache ``{"k", "v", "len", "tables"}`` (+ ``k_scale`` /
      ``v_scale`` for a quantized pool) — one decode token per slot,
      written at ``(tables[s, len // bs], len % bs)``, then attention over
      each slot's ``len + 1`` rows.

    Cache writes are **in place** (the reference returns new arrays).  A
    quantized pool stores codes: a block's scale is stamped from its first
    row (``row == 0``) and later rows reuse it with a clipped encode, so a
    block's codes always decode through the scale they were written with.

    Returns ``(out [B, T, Hq*D], cache', (k, v))``."""
    b, tq, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        ctx = ops.attention(q, k, v, cfg.attention_spec, causal=True,
                            sliding_window=cfg.sliding_window)
        return ctx.reshape(b, tq, -1), None, (k, v)

    if "tables" not in cache:
        # linear staging cache (chunked prefill): append, then attend
        start = int(cache["len"])
        ck, cv = cache["k"], cache["v"]
        if start + tq > ck.shape[1]:
            raise ValueError(f"staging cache of {ck.shape[1]} rows cannot take "
                             f"{tq} rows at {start}")
        ck[:, start:start + tq] = k.to(ck.dtype)
        cv[:, start:start + tq] = v.to(cv.dtype)
        valid = torch.full((b,), start + tq, dtype=torch.int32, device=x.device)
        ctx = ops.attention(q, ck, cv, cfg.attention_spec, causal=True,
                            sliding_window=cfg.sliding_window, q_offset=start,
                            kv_valid_len=valid)
        return ctx.reshape(b, tq, -1), {"k": ck, "v": cv, "len": start + tq}, (k, v)

    if tq != 1 or paged_cache_t is None:
        raise ValueError("the paged cache takes one decode token per slot and paged_cache_t")
    if cfg.sliding_window is not None and paged_cache_t <= cfg.sliding_window:
        raise NotImplementedError("sliding-window ring caches are not ported yet")
    ck, cv, tables = cache["k"], cache["v"], cache["tables"]
    bs = ck.shape[1]
    idx = cache["len"].long()
    col = torch.clamp(idx // bs, 0, tables.shape[1] - 1)
    blk = tables.gather(1, col[:, None])[:, 0].long()
    row = idx % bs
    new_len = cache["len"] + 1
    kv_dtype = kvquant.dtype_of(ck.dtype)
    kv_scales = None
    if kv_dtype != "fp32":
        ks_pages, vs_pages = cache["k_scale"], cache["v_scale"]
        fresh = (row == 0)[:, None]
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
    spec = dataclasses.replace(cfg.paged_attention_spec, block_size=bs, kv_dtype=kv_dtype)
    ctx = ops.paged_attention(q, ck, cv, tables, spec, kv_valid_len=new_len,
                              kv_len=paged_cache_t, kv_scales=kv_scales)
    new_cache = {"k": ck, "v": cv, "len": new_len}
    if kv_scales is not None:
        new_cache["k_scale"], new_cache["v_scale"] = kv_scales
    return ctx.reshape(b, tq, -1), new_cache, (k, v)


def attention_out(p: Params, ctx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return ctx @ p["wo"].to(cdtype(cfg))


# ---------------------------------------------------------------------------
# MLP


def spec_mlp(cfg: ModelConfig) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    pd = pdtype(cfg)
    if cfg.mlp_type == "swiglu":
        return {"wi": ParamSpec((d, f), pd), "wg": ParamSpec((d, f), pd),
                "wo": ParamSpec((f, d), pd)}
    return {"wi": ParamSpec((d, f), pd), "wo": ParamSpec((f, d), pd)}


def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    h = x @ p["wi"].to(dt)
    if cfg.mlp_type == "swiglu":
        h = torch.nn.functional.silu(x @ p["wg"].to(dt)) * h
    else:
        h = torch.nn.functional.gelu(h, approximate="tanh")  # jax.nn.gelu default
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# causal depthwise conv (mamba2)


def spec_conv1d(cfg: ModelConfig, channels: int, width: int) -> Params:
    return {"kernel": ParamSpec((width, channels), pdtype(cfg), "fan_in")}


def causal_conv1d(
    p: Params, x: torch.Tensor, state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv.  x ``[B, T, C]``; ``state`` ``[B, W-1, C]``
    carries the context for decode.  Returns ``(y, new_state)``: without a
    state, ``new_state`` is None; with one, the last ``W-1`` input rows."""
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
# loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over positions with ``label >= 0`` (float32
    reductions)."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(lg - m).sum(dim=-1))
    picked = lg.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp(min=1.0)
