"""Mamba-2 (SSD — state-space duality) language model (port of
``repro.models.ssm``).

Attention-free: the paper's softmax engine has no place in the mixer; STAR
shapes only the sampling distribution.  The chunked SSD algorithm mirrors
the blocked attention pipeline: an intra-chunk quadratic part and an
inter-chunk recurrent state, scanned over chunks.

Shapes: d_inner = expand*d_model, H = d_inner/headdim heads, state N,
ngroups G = 1 (B/C shared across heads).

One difference of route from the reference: the reference mixer calls its
plain ``_ssd_chunk_scan`` directly; here prefill goes through
``ops.ssd_scan``, whose ``reference`` impl is that same function and whose
default ``pallas`` impl is the CUDA kernel the reference wrote for it; a
training forward (inputs that need a gradient) takes ``reference``, as the
reference's training does, since the kernel has no backward.  The
reference's ``scan`` over stacked layers is a Python loop over the ``[L]``
axis, and caches are updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import with_logical_constraint as wlc
from repro_torch.distributed.sharding import zeros_placed
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, layer, stack_specs, tree_map
from repro_torch.ops.platform import Device, resolve_device

Params = Dict[str, Any]


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, heads, conv_dim


def spec_mamba_block(cfg: ModelConfig) -> Params:
    d = cfg.d_model
    d_inner, heads, conv_dim = _dims(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    pd = L.pdtype(cfg)
    return {
        "ln": L.spec_rmsnorm(cfg),
        "in_proj": ParamSpec((d, 2 * d_inner + 2 * gn + heads), ("embed", "mlp"), pd,
                             "fan_in"),
        "conv": L.spec_conv1d(cfg, conv_dim, cfg.ssm_conv),
        "A_log": ParamSpec((heads,), (None,), pd, "zeros"),
        "D": ParamSpec((heads,), (None,), pd, "ones"),
        "dt_bias": ParamSpec((heads,), (None,), pd, "zeros"),
        "out_norm": ParamSpec((d_inner,), ("mlp",), pd, "ones"),
        "out_proj": ParamSpec((d_inner, d), ("mlp", "embed"), pd, "fan_in"),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, heads, _ = _dims(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    z, x, bc, dt = torch.split(zxbcdt, [d_inner, d_inner, 2 * gn, heads], dim=-1)
    bmat, cmat = torch.split(bc, gn, dim=-1)
    return z, x, bmat, cmat, dt


def _ssd_chunk_scan(
    x: torch.Tensor,  # [B, T, H, P] (pre-multiplied by dt)
    a: torch.Tensor,  # [B, T, H] log-decay (negative)
    bmat: torch.Tensor,  # [B, T, N]
    cmat: torch.Tensor,  # [B, T, N]
    h0: Optional[torch.Tensor],  # [B, H, N, P] initial state or None
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns ``(y [B,T,H,P], final state [B,H,N,P])``,
    float32.  The plain version of the ``ssd_scan`` kernel."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-t) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = (t + pad) // chunk
    hprev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq = x[:, sl].float()  # [B, Q, H, P]
        bq, cq = bmat[:, sl].float(), cmat[:, sl].float()  # [B, Q, N]
        ca = torch.cumsum(a[:, sl].float(), dim=1)  # inclusive [B, Q, H]
        last = ca[:, -1, :]  # [B, H]
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)
        decay = torch.exp(ca[:, :, None, :] - ca[:, None, :, :])  # [B, Q, K, H]
        decay = torch.where(tri[None, :, :, None], decay, torch.zeros_like(decay))
        y_intra = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, decay, xq)
        y_inter = torch.einsum("bqn,bhnp->bqhp", cq, hprev) * torch.exp(ca)[..., None]
        s_c = torch.einsum("bkn,bkhp,bkh->bhnp", bq, xq, torch.exp(last[:, None, :] - ca))
        hprev = hprev * torch.exp(last)[:, :, None, None] + s_c
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :t] if ys else x.new_zeros((b, 0, h, p), dtype=torch.float32)
    return y, hprev


def mamba_mixer(
    p: Params,
    x_in: torch.Tensor,  # [B, T, D]
    cfg: ModelConfig,
    cache: Optional[Params] = None,  # {"conv": [B, W-1, conv_dim], "ssm": [B, H, N, P]}
    return_state: bool = False,  # prefill: chunk-scan but emit a cache
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Without ``cache``: the chunk scan through ``ops.ssd_scan`` (and, with
    ``return_state``, the new cache).  With one: the exact per-token
    recurrence (decode, T small), in plain PyTorch as the reference keeps it
    outside any kernel."""
    dt_ = L.cdtype(cfg)
    d_inner, heads, _ = _dims(cfg)
    pdim = cfg.ssm_headdim
    zxbcdt = L.linear(x_in, p["in_proj"].to(dt_))
    z, x, bmat, cmat, dtproj = _split_proj(cfg, zxbcdt)

    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    conv_out, new_conv = L.causal_conv1d(
        p["conv"], conv_in, None if cache is None else cache["conv"])
    if cache is None and return_state:
        w1 = cfg.ssm_conv - 1
        # the last W-1 input rows, zero-filled ahead of a prompt shorter than that
        new_conv = L.pad_rows(conv_in, w1, 0)[:, -w1:, :]
    conv_out = F.silu(conv_out)
    x, bmat, cmat = torch.split(conv_out, [d_inner, bmat.shape[-1], cmat.shape[-1]], dim=-1)

    b, t = x.shape[0], x.shape[1]
    xh = L.split_heads(x, b, t, heads, pdim)
    dtf = dtproj.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dtf, torch.zeros_like(dtf))  # softplus, as jax.nn.softplus
    a_decay = -torch.exp(p["A_log"].float()) * dt  # negative log-decay [B, T, H]
    xdt = xh.float() * dt[..., None]

    # G=1: B/C shared across heads
    bm = bmat[..., :cfg.ssm_state]
    cm = cmat[..., :cfg.ssm_state]

    if cache is None:
        # a training forward (inputs that need a gradient) takes the plain
        # scan, the reference's own route: the kernel has no backward
        grad = torch.is_grad_enabled() and xdt.requires_grad
        spec = ops.ScanSpec(impl="reference" if grad else "pallas", chunk=cfg.ssm_chunk)
        y, hfin = ops.ssd_scan(xdt, a_decay, bm, cm, spec)
        new_cache = {"conv": new_conv.to(dt_), "ssm": hfin} if return_state else None
    else:
        h = cache["ssm"].float()
        bf, cf = bm.float(), cm.float()
        ys = []
        for i in range(t):
            h = h * torch.exp(a_decay[:, i])[:, :, None, None] + torch.einsum(
                "bn,bhp->bhnp", bf[:, i], xdt[:, i])
            ys.append(torch.einsum("bn,bhnp->bhp", cf[:, i], h))
        y = torch.stack(ys, dim=1)
        new_cache = {"conv": new_conv, "ssm": h}

    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = L.merge_heads(y).to(dt_)
    y = y * F.silu(z)
    # gated RMSNorm
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps) * p["out_norm"].float()).to(dt_)
    return wlc(L.linear(y, p["out_proj"].to(dt_)), ("batch", "seq", "embed")), new_cache


class MambaLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "ssm":
            raise ValueError(f"MambaLM is the ssm family, got {cfg.family!r}")
        self.cfg = cfg.validate()

    def block_spec(self) -> Params:
        return spec_mamba_block(self.cfg)

    def param_specs(self) -> Params:
        cfg = self.cfg
        return {
            "embed": L.spec_embedding(cfg),
            "blocks": stack_specs(self.block_spec(), cfg.num_layers),
            "final_norm": L.spec_rmsnorm(cfg),
            "unembed": L.spec_unembed(cfg),
        }

    def _block(self, bp: Params, h: torch.Tensor, cache=None, return_state=False):
        hin = L.rmsnorm(bp["ln"], h, self.cfg.norm_eps)
        out, new_cache = mamba_mixer(bp, hin, self.cfg, cache, return_state)
        return h + out, new_cache

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward -> logits ``[B, T, V]``."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens, cfg)
        for i in range(cfg.num_layers):
            h = L.remat(cfg, lambda bp, x: self._block(bp, x)[0], layer(params["blocks"], i), h)
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return L.unembed(params["unembed"], h, cfg, params["embed"])

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return L.cross_entropy(self.forward(params, batch["tokens"]), batch["labels"])

    # -- serving: a constant-size state cache --------------------------------

    def cache_spec(self, batch: int, max_len: int) -> Params:
        """Spec tree of :meth:`init_cache` (the reference's ``cache_spec``);
        ``max_len`` bounds nothing."""
        cfg = self.cfg
        _, heads, conv_dim = _dims(cfg)
        return {
            "layers": {
                "conv": ParamSpec((cfg.num_layers, batch, cfg.ssm_conv - 1, conv_dim),
                                  ("layers", "batch", None, "mlp"), L.cdtype(cfg), "zeros"),
                "ssm": ParamSpec((cfg.num_layers, batch, heads, cfg.ssm_state, cfg.ssm_headdim),
                                 ("layers", "batch", "heads", None, None), torch.float32,
                                 "zeros"),
            },
            "len": ParamSpec((), (), torch.int32, "zeros"),
        }

    def init_cache(self, batch: int, device: Device = None) -> Params:
        """Zero cache of the reference's ``cache_spec``: per layer the conv
        context ``[L, B, W-1, conv_dim]`` in the compute dtype and the SSM
        state ``[L, B, H, N, P]`` in float32; ``len`` 0.  Under a mesh each
        leaf is placed by its axes."""
        dev = resolve_device(device)
        return tree_map(lambda s: zeros_placed(s.shape, s.axes, s.dtype, dev),
                        self.cache_spec(batch, 0))

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Params]:
        """Process a prompt: (last-position logits ``[B, 1, V]``, cache).
        The state is constant-size, so ``max_len`` bounds nothing."""
        cfg = self.cfg
        cache = self.init_cache(tokens.shape[0], tokens.device)
        layers = cache["layers"]
        h = L.embed(params["embed"], tokens, cfg)
        for i in range(cfg.num_layers):
            h, state = self._block(layer(params["blocks"], i), h, return_state=True)
            L.write_rows(layers["conv"][i], state["conv"])
            L.write_rows(layers["ssm"][i], state["ssm"])
        h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        cache["len"].fill_(tokens.shape[1])
        return logits, cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens ``[B, t]`` -> (logits ``[B, t, V]``, the same cache): the
        conv and SSM states and ``len`` are updated in place, so a CUDA graph
        of the step owns them."""
        cfg = self.cfg
        layers = cache["layers"]
        h = L.embed(params["embed"], tokens, cfg)
        for i in range(cfg.num_layers):
            layer_cache = {"conv": layers["conv"][i], "ssm": layers["ssm"][i]}
            h, state = self._block(layer(params["blocks"], i), h, cache=layer_cache)
            layers["conv"][i] = state["conv"]
            layers["ssm"][i] = state["ssm"]
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        cache["len"].add_(tokens.shape[1])
        return logits, cache
