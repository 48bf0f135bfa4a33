"""RecurrentGemma (Griffin) hybrid: RG-LRU recurrent blocks beside local
attention (port of ``repro.models.rglru``).

Pattern (``cfg.block_pattern``): ("recurrent", "recurrent", "attention")
repeated; 26 layers = 8 periods of 3, stacked on a leading ``[P]`` axis of
the parameter tree as in the reference (``"periods"``), plus a 2-layer
recurrent tail (``tail0``, ``tail1``).  The reference's ``scan`` over the
periods is a Python loop here.  The local-attention blocks run through the
STAR softmax engine over a window of ``cfg.local_window``; the RG-LRU
blocks have no softmax.

RG-LRU recurrence: ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)``, with
``a_t = exp(-c r_t softplus(lam))`` and the gates ``r, i = sigmoid(x W)``.
The gates, ``lam``, the decay and the state are float32, their weights
``wa`` / ``wi`` read in float32 (``models.param.compute_params`` leaves
them so); only ``wx``, ``wgate`` and ``wout`` go through the compute dtype.
Prefill runs the recurrence as a log-depth scan in plain PyTorch (the
reference's ``jax.lax.associative_scan``: no Pallas kernel), decode one
step.

The lockstep cache: per recurrent block the conv context ``[.., B, W-1,
w]`` (compute dtype) and the state ``h`` ``[.., B, w]`` (float32); per
attention block a ring of ``min(max_len, local_window)`` rows (slot =
position % rows); one scalar ``len``.  ``decode_step`` updates all of it in
place (the reference returns new arrays), so a CUDA graph of the step owns
the cache.  When ``max_len < local_window`` the ring holds only
``max_len`` rows, so decode attends to fewer than ``local_window`` tokens
once it wraps: the reference's behaviour, kept.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor, scan_on_shards, zeros_placed
from repro_torch.distributed.sharding import with_logical_constraint as wlc
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, layer, stack_specs, tree_map
from repro_torch.ops.platform import Device, resolve_device

Params = Dict[str, Any]
_LRU_C = 8.0


def spec_rglru_block(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    pd = L.pdtype(cfg)
    return {
        "ln": L.spec_rmsnorm(cfg),
        "wx": ParamSpec((d, w), ("embed", "mlp"), pd, "fan_in"),
        "wgate": ParamSpec((d, w), ("embed", "mlp"), pd, "fan_in"),
        "conv": L.spec_conv1d(cfg, w, cfg.conv_width),
        "wa": ParamSpec((w, w), ("embed", "mlp"), pd, "fan_in"),
        "wi": ParamSpec((w, w), ("embed", "mlp"), pd, "fan_in"),
        "lam": ParamSpec((w,), ("mlp",), pd, "ones"),
        "wout": ParamSpec((w, d), ("mlp", "embed"), pd, "fan_in"),
        "ln_mlp": L.spec_rmsnorm(cfg),
        "mlp": L.spec_mlp(cfg),
    }


def spec_attn_block(cfg: ModelConfig) -> Params:
    return {
        "ln": L.spec_rmsnorm(cfg),
        "attn": L.spec_attention(cfg),
        "ln_mlp": L.spec_rmsnorm(cfg),
        "mlp": L.spec_mlp(cfg),
    }


def rglru_scan(
    x: torch.Tensor,  # [B, T, W] gated input (i_t * x_t already applied)
    a: torch.Tensor,  # [B, T, W] decay in (0, 1)
    h0: Optional[torch.Tensor],  # [B, W]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The linear recurrence ``h_t = a_t h_{t-1} + b_t``, ``b_t = sqrt(1 -
    a_t^2) x_t``, with ``h0`` folded into the first step as the reference
    does.  Hillis–Steele doubling: ``ceil(log2 T)`` rounds of ``(a, b)[t] <-
    (a[t - d] a[t], b[t - d] a[t] + b[t])``, the reference's combine, in
    another order of association (float32 rounding apart).  Returns
    ``(h_all [B, T, W], h_last [B, W])``.  Under a mesh it runs on each
    rank's shard (``distributed.sharding.scan_on_shards``)."""
    if is_dtensor(x):
        return scan_on_shards(rglru_scan, x, a, h0)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * x
    # new tensors each round, no write in place: autograd differentiates it
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    t = x.shape[1]
    d = 1
    while d < t:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        if 2 * d < t:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b, b[:, -1]


def recurrent_block(
    p: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Params] = None,  # {"conv": [B, W-1, w], "h": [B, w]}
    return_state: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """The RG-LRU block and its MLP.  With ``cache`` (decode) or
    ``return_state`` (prefill) it also returns the new ``{"conv", "h"}``."""
    dt = L.cdtype(cfg)
    x_in = L.rmsnorm(p["ln"], h, cfg.norm_eps)
    xb = L.linear(x_in, p["wx"].to(dt))
    gate = F.gelu(L.linear(x_in, p["wgate"].to(dt)), approximate="tanh")  # jax.nn.gelu default

    conv_out, new_conv = L.causal_conv1d(p["conv"], xb, None if cache is None else cache["conv"])
    if cache is None and return_state:
        w1 = cfg.conv_width - 1
        # the last W-1 input rows, zero-filled ahead of a prompt shorter than that
        new_conv = L.pad_rows(xb, w1, 0)[:, -w1:, :]

    xf = conv_out.float()
    r = torch.sigmoid(L.linear(xf, p["wa"].float()))
    i = torch.sigmoid(L.linear(xf, p["wi"].float()))
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    a = torch.exp(-_LRU_C * r * softplus)
    gated = i * xf

    h0 = None if cache is None else cache["h"].float()
    hs, h_last = rglru_scan(gated, a, h0)
    y = wlc(hs.to(dt) * gate, ("batch", "seq", "mlp"))
    out = wlc(L.linear(y, p["wout"].to(dt)), ("batch", "seq", "embed"))
    new_cache = None
    if cache is not None or return_state:
        new_cache = {"conv": new_conv, "h": h_last.float()}
    res = h + out
    hn = L.rmsnorm(p["ln_mlp"], res, cfg.norm_eps)
    return res + L.mlp(p["mlp"], hn, cfg), new_cache


def local_attn_block(
    p: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Params] = None,  # {"k", "v": the ring, "len"}
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal attention over ``cfg.local_window`` and its MLP; a cache's ring
    takes the step's K/V row in place.  Returns ``(h, (k, v))``: the fresh
    K/V, which prefill fits into the ring."""
    a, _, kv = L.attention_block(
        p["attn"], L.rmsnorm(p["ln"], h, cfg.norm_eps), cfg,
        causal=True, sliding_window=cfg.local_window, cache=cache,
    )
    res = h + L.attention_out(p["attn"], a, cfg)
    hn = L.rmsnorm(p["ln_mlp"], res, cfg.norm_eps)
    return res + L.mlp(p["mlp"], hn, cfg), kv


class RecurrentGemmaLM:
    """(R, R, A) periods, then the unrolled tail."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "hybrid":
            raise ValueError(f"RecurrentGemmaLM is the hybrid family, got {cfg.family!r}")
        self.cfg = cfg.validate()
        period = len(cfg.block_pattern)
        self.num_periods = cfg.num_layers // period
        self.tail = cfg.num_layers - self.num_periods * period

    def _kind(self, i: int) -> str:
        return self.cfg.block_pattern[i % len(self.cfg.block_pattern)]

    def _spec(self, kind: str) -> Params:
        return spec_rglru_block(self.cfg) if kind == "recurrent" else spec_attn_block(self.cfg)

    def period_spec(self) -> Params:
        return {f"b{idx}": self._spec(kind) for idx, kind in enumerate(self.cfg.block_pattern)}

    def param_specs(self) -> Params:
        cfg = self.cfg
        specs: Params = {
            "embed": L.spec_embedding(cfg),
            "periods": stack_specs(self.period_spec(), self.num_periods),
            "final_norm": L.spec_rmsnorm(cfg),
            "unembed": L.spec_unembed(cfg),
        }
        for i in range(self.tail):
            specs[f"tail{i}"] = self._spec(self._kind(i))
        return specs

    def _blocks(self, params: Params):
        """Every block in order: ``(kind, its params, where its cache lives:
        (the cache key path, the period index or None))``."""
        for i in range(self.num_periods):
            pp = layer(params["periods"], i)
            for idx, kind in enumerate(self.cfg.block_pattern):
                yield kind, pp[f"b{idx}"], (("periods", f"b{idx}"), i)
        for i in range(self.tail):
            yield self._kind(i), params[f"tail{i}"], ((f"tail{i}",), None)

    @staticmethod
    def _slot(cache: Params, where) -> Params:
        """The leaves of one block's cache (a period's row of the stacked
        leaves, or a tail block's own): views, so writes land in place."""
        path, i = where
        node = cache
        for key in path:
            node = node[key]
        return {name: leaf if i is None else leaf[i] for name, leaf in node.items()}

    def cache_len(self, max_len: int) -> int:
        """The attention blocks' ring rows: ``min(max_len, local_window)``."""
        return min(max_len, self.cfg.local_window)

    def cache_spec(self, batch: int, max_len: int) -> Params:
        """Spec tree of :meth:`init_cache` (the reference's ``cache_spec``):
        the rings' rows along "kv_seq"."""
        cfg = self.cfg
        w = cfg.lru_width or cfg.d_model
        dt = L.cdtype(cfg)

        def block(kind, lead, lead_axes):
            if kind == "recurrent":
                return {"conv": ParamSpec(lead + (batch, cfg.conv_width - 1, w),
                                          lead_axes + ("batch", None, "mlp"), dt, "zeros"),
                        "h": ParamSpec(lead + (batch, w), lead_axes + ("batch", "mlp"),
                                       torch.float32, "zeros")}
            kv = lead + (batch, self.cache_len(max_len), cfg.num_kv_heads,
                         cfg.resolved_head_dim)
            axes = lead_axes + ("batch", "kv_seq", "kv_heads", None)
            return {"k": ParamSpec(kv, axes, dt, "zeros"), "v": ParamSpec(kv, axes, dt, "zeros")}

        spec: Params = {
            "periods": {f"b{idx}": block(kind, (self.num_periods,), ("layers",))
                        for idx, kind in enumerate(cfg.block_pattern)},
            "len": ParamSpec((), (), torch.int32, "zeros"),
        }
        for i in range(self.tail):
            spec[f"tail{i}"] = block(self._kind(i), (), ())
        return spec

    def init_cache(self, batch: int, max_len: int, device: Device = None) -> Params:
        """Zeroed cache of :meth:`cache_spec`: conv ``[P, B, W-1, w]`` / ``[B,
        W-1, w]`` in the compute dtype, ``h`` ``[P, B, w]`` / ``[B, w]`` in
        float32, rings ``[P, B, t, Hkv, D]`` / ``[B, t, Hkv, D]`` with ``t =
        cache_len(max_len)``; ``len`` 0.  Under a mesh each leaf is placed
        by its axes."""
        dev = resolve_device(device)
        return tree_map(lambda s: zeros_placed(s.shape, s.axes, s.dtype, dev),
                        self.cache_spec(batch, max_len))

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        h = L.rmsnorm(params["final_norm"], h, self.cfg.norm_eps)
        return L.unembed(params["unembed"], h, self.cfg, params["embed"])

    def forward(self, params: Params, tokens: torch.Tensor, **_) -> torch.Tensor:
        """Full-sequence forward -> logits ``[B, T, V]``."""
        h = L.embed(params["embed"], tokens, self.cfg)
        for kind, bp, _ in self._blocks(params):
            block = recurrent_block if kind == "recurrent" else local_attn_block
            # the block bound now: the backward pass recomputes it after the loop
            h = L.remat(self.cfg, lambda p, x, f=block: f(p, x, self.cfg)[0], bp, h)
        return self._logits(params, h)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return L.cross_entropy(self.forward(params, batch["tokens"]), batch["labels"])

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int, **_
                ) -> Tuple[torch.Tensor, Params]:
        """Process a prompt: (last-position logits ``[B, 1, V]``, cache).
        Each attention block's K/V go into its ring by
        ``layers.fit_window_cache`` (the last ``cache_len(max_len)`` rows,
        slot = position % rows)."""
        cfg = self.cfg
        b, t = tokens.shape
        cache = self.init_cache(b, max_len, tokens.device)
        wlen = self.cache_len(max_len)
        h = L.embed(params["embed"], tokens, cfg)
        for kind, bp, where in self._blocks(params):
            slot = self._slot(cache, where)
            if kind == "recurrent":
                h, state = recurrent_block(bp, h, cfg, return_state=True)
            else:
                h, (k, v) = local_attn_block(bp, h, cfg)
                state = dict(zip(("k", "v"), L.fit_window_cache(k, v, 1, wlen, t)))
            for name, leaf in slot.items():
                L.write_rows(leaf, state[name])
        cache["len"].fill_(t)
        # rmsnorm is positionwise: norming the last row alone matches the
        # reference's norm-then-slice
        return self._logits(params, h[:, -1:]), cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the same cache): every
        conv window, RG-LRU state and ring row, then ``len``, updated in
        place, so a CUDA graph of the step owns the cache."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens, cfg)
        for kind, bp, where in self._blocks(params):
            slot = self._slot(cache, where)
            if kind == "recurrent":
                h, state = recurrent_block(bp, h, cfg, cache=slot)
                slot["conv"].copy_(state["conv"])
                slot["h"].copy_(state["h"])
            else:  # the ring takes the step's row in place
                h, _ = local_attn_block(bp, h, cfg, cache={**slot, "len": cache["len"]})
        cache["len"].add_(tokens.shape[1])
        return self._logits(params, h), cache
