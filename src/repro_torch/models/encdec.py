"""Encoder-decoder backbone, seamless-m4t-large-v2 (port of
``repro.models.encdec``).

The modality frontend is a stub, as in the reference: a request brings
precomputed frame embeddings ``[B, T_src, frontend_dim]`` that
``frontend_proj`` maps into the model, plus sinusoidal positions.  The
encoder's self-attention is non-causal; the text decoder (token embeddings
plus sinusoidal positions) runs causal self-attention, then
cross-attention to the encoder's output (K/V from the memory, never
causal), both through the STAR softmax engine; no rope anywhere.  Pre-LN
LayerNorm as in the NLLB / seamless stack.  The reference's ``scan`` over
stacked layers is a Python loop over the ``[L]`` axis.

The lockstep cache: the decoder's self K/V ``[Ld, B, max_len, H, D]``, the
cross K/V ``[Ld, B, T_src, H, D]`` projected once per decoder layer at
prefill, and a scalar ``len``.  ``decode_step`` writes its self K/V row and
advances ``len`` in place (the reference returns new arrays), so a CUDA
graph of the step owns the cache.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, layer, stack_specs

Params = Dict[str, Any]


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM is the encdec family, got {cfg.family!r}")
        self.cfg = cfg.validate()

    # -- parameters -----------------------------------------------------------

    def enc_block_spec(self) -> Params:
        cfg = self.cfg
        return {"ln1": L.spec_layernorm(cfg), "attn": L.spec_attention(cfg),
                "ln2": L.spec_layernorm(cfg), "mlp": L.spec_mlp(cfg)}

    def dec_block_spec(self) -> Params:
        cfg = self.cfg
        return {"ln1": L.spec_layernorm(cfg), "self_attn": L.spec_attention(cfg),
                "ln2": L.spec_layernorm(cfg), "cross_attn": L.spec_attention(cfg),
                "ln3": L.spec_layernorm(cfg), "mlp": L.spec_mlp(cfg)}

    def param_specs(self) -> Params:
        cfg = self.cfg
        fd = cfg.frontend_dim or cfg.d_model
        return {
            "frontend_proj": {"kernel": ParamSpec((fd, cfg.d_model), (None, "embed"),
                                                        L.pdtype(cfg), "fan_in")},
            "embed": L.spec_embedding(cfg),
            "enc_blocks": stack_specs(self.enc_block_spec(), cfg.num_layers),
            "enc_norm": L.spec_layernorm(cfg),
            "dec_blocks": stack_specs(self.dec_block_spec(), cfg.num_decoder_layers),
            "dec_norm": L.spec_layernorm(cfg),
            "unembed": L.spec_unembed(cfg),
        }

    # -- encoder ----------------------------------------------------------------

    def encode(self, params: Params, src_embeds) -> torch.Tensor:
        """Frame embeddings ``[B, T_src, frontend_dim]`` -> memory ``[B,
        T_src, d_model]`` in the compute dtype."""
        cfg = self.cfg
        dt = L.cdtype(cfg)
        dev = params["frontend_proj"]["kernel"].device
        src = torch.as_tensor(src_embeds, device=dev)
        h = L.linear(src.to(dt), params["frontend_proj"]["kernel"].to(dt))
        h = h + L.sinusoidal_positions(0, h.shape[1], cfg.d_model, dev).to(dt)[None]
        for i in range(cfg.num_layers):
            h = L.remat(cfg, self._enc_block, layer(params["enc_blocks"], i), h)
        return L.layernorm(params["enc_norm"], h, cfg.norm_eps)

    def _enc_block(self, bp: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        a, _, _ = L.attention_block(bp["attn"], L.layernorm(bp["ln1"], h, cfg.norm_eps), cfg,
                                    causal=False, use_rope=False)
        h = h + L.attention_out(bp["attn"], a, cfg)
        return h + L.mlp(bp["mlp"], L.layernorm(bp["ln2"], h, cfg.norm_eps), cfg)

    # -- decoder ----------------------------------------------------------------

    def _dec_block(self, bp: Params, h: torch.Tensor, memory: torch.Tensor):
        """One decoder block over a whole sequence: ``(h, self (k, v), cross
        (k, v))``, the fresh K/V of both attentions."""
        cfg = self.cfg
        a, _, self_kv = L.attention_block(
            bp["self_attn"], L.layernorm(bp["ln1"], h, cfg.norm_eps), cfg,
            causal=True, use_rope=False)
        h = h + L.attention_out(bp["self_attn"], a, cfg)
        c, _, cross_kv = L.attention_block(
            bp["cross_attn"], L.layernorm(bp["ln2"], h, cfg.norm_eps), cfg,
            xkv=memory, use_rope=False)
        h = h + L.attention_out(bp["cross_attn"], c, cfg)
        h = h + L.mlp(bp["mlp"], L.layernorm(bp["ln3"], h, cfg.norm_eps), cfg)
        return h, self_kv, cross_kv

    def _embed_tokens(self, params: Params, tokens: torch.Tensor, pos0) -> torch.Tensor:
        cfg = self.cfg
        x = L.embed(params["embed"], tokens, cfg)
        pe = L.sinusoidal_positions(pos0, tokens.shape[1], cfg.d_model, tokens.device)
        return x + pe.to(L.cdtype(cfg))[None]

    def decode_seq(self, params: Params, memory: torch.Tensor, tokens: torch.Tensor,
                   pos0=0) -> torch.Tensor:
        """Full-sequence causal decoder -> hidden states ``[B, T, d_model]``."""
        cfg = self.cfg
        h = self._embed_tokens(params, tokens, pos0)
        for i in range(cfg.num_decoder_layers):
            h = L.remat(cfg, lambda bp, x, mem: self._dec_block(bp, x, mem)[0],
                        layer(params["dec_blocks"], i), h, memory)
        return L.layernorm(params["dec_norm"], h, cfg.norm_eps)

    # -- public API -------------------------------------------------------------

    def forward(self, params: Params, batch_or_tokens, *,
                src_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Training forward: ``{"src_embeds", "tokens"}`` or tokens with
        ``src_embeds`` -> logits ``[B, T, V]``."""
        if isinstance(batch_or_tokens, dict):
            src_embeds, tokens = batch_or_tokens["src_embeds"], batch_or_tokens["tokens"]
        else:
            tokens = batch_or_tokens
        h = self.decode_seq(params, self.encode(params, src_embeds), tokens)
        return L.unembed(params["unembed"], h, self.cfg, params["embed"])

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return L.cross_entropy(self.forward(params, batch), batch["labels"])

    # -- serving ------------------------------------------------------------------

    def cache_len(self, max_len: int) -> int:
        """The self cache's rows: ``max_len`` (no window)."""
        return max_len

    def cache_spec(self, batch: int, max_len: int, src_len: int = 4096) -> Params:
        """Spec tree of the decode cache (the reference's ``cache_spec``):
        self K/V ``[L, B, max_len, Hkv, D]`` and cross K/V ``[L, B, src_len,
        Hkv, D]`` in the compute dtype, rows along "kv_seq"; scalar
        ``len``."""
        cfg = self.cfg
        dt = L.cdtype(cfg)
        hd = cfg.resolved_head_dim
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        out: Params = {}
        for part, rows in (("self", max_len), ("cross", src_len)):
            kv = (cfg.num_decoder_layers, batch, rows, cfg.num_kv_heads, hd)
            out[part] = {"k": ParamSpec(kv, axes, dt, "zeros"), "v": ParamSpec(kv, axes, dt, "zeros")}
        out["len"] = ParamSpec((), (), torch.int32, "zeros")
        return out

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int, *,
                src_embeds, **_) -> Tuple[torch.Tensor, Params]:
        """Encode the source, run the decoder over the prompt and prime the
        caches: (last-position logits ``[B, 1, V]``, cache).  The self K/V
        are zero past the prompt (``layers.fit_window_cache`` over
        ``max_len``); the cross K/V are the memory's projections through
        each decoder layer's ``wk`` / ``wv``, taken from the prompt's own
        cross-attention (the reference projects them again: the same
        products)."""
        cfg = self.cfg
        b, t = tokens.shape
        if t > max_len:
            raise ValueError(f"prefill length {t} exceeds cache capacity {max_len}; pass a "
                             "larger max_len")
        memory = self.encode(params, src_embeds)
        h = self._embed_tokens(params, tokens, 0)
        kv = {"self": {"k": [], "v": []}, "cross": {"k": [], "v": []}}
        for i in range(cfg.num_decoder_layers):
            h, (sk, sv), (xk, xv) = self._dec_block(layer(params["dec_blocks"], i), h, memory)
            sk, sv = L.fit_window_cache(sk, sv, 1, max_len, t)
            for part, k, v in (("self", sk, sv), ("cross", xk, xv)):
                kv[part]["k"].append(k)
                kv[part]["v"].append(v)
        h = L.layernorm(params["dec_norm"], h[:, -1:], cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        cache: Params = {part: {name: torch.stack(rows) for name, rows in leaves.items()}
                         for part, leaves in kv.items()}
        cache["len"] = torch.tensor(t, dtype=torch.int32, device=tokens.device)
        return logits, cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the same cache): each
        layer's self K/V row at ``len``, then ``len``, updated in place;
        cross-attention reads the cached cross K/V, non-causally."""
        cfg = self.cfg
        dt = L.cdtype(cfg)
        b = tokens.shape[0]
        h = self._embed_tokens(params, tokens, cache["len"])
        selfc, cross = cache["self"], cache["cross"]
        for i in range(cfg.num_decoder_layers):
            bp = layer(params["dec_blocks"], i)
            sc = {"k": selfc["k"][i], "v": selfc["v"][i], "len": cache["len"]}
            a, _, _ = L.attention_block(bp["self_attn"], L.layernorm(bp["ln1"], h, cfg.norm_eps),
                                        cfg, causal=True, cache=sc, use_rope=False)
            h = h + L.attention_out(bp["self_attn"], a, cfg)
            hn = L.layernorm(bp["ln2"], h, cfg.norm_eps)
            q = L.split_heads(L.linear(hn, bp["cross_attn"]["wq"].to(dt)), b, 1,
                              cfg.num_heads, cfg.resolved_head_dim)
            ctx = ops.attention(q, cross["k"][i], cross["v"][i], cfg.attention_spec,
                                causal=False, sliding_window=None)
            h = h + L.attention_out(bp["cross_attn"], L.merge_heads(ctx), cfg)
            h = h + L.mlp(bp["mlp"], L.layernorm(bp["ln3"], h, cfg.norm_eps), cfg)
        h = L.layernorm(params["dec_norm"], h, cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        cache["len"].add_(1)
        return logits, cache
