"""Decoder-only transformer LM, dense family (port of
``repro.models.transformer.DecoderLM``: forward, prefill and the paged
decode path).  The reference's ``scan`` over stacked layers is a Python
loop over the ``[L]`` axis of the parameter tree.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, tree_map
from repro_torch.ops.platform import Device, resolve_device

Params = Dict[str, Any]


def _layer(tree, i: int):
    return tree_map(lambda x: x[i], tree)


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise ValueError(f"only the dense family is ported, got {cfg.family!r}")
        self.cfg = cfg.validate()

    # -- parameters -----------------------------------------------------------

    def block_spec(self) -> Params:
        cfg = self.cfg
        return {
            "ln1": L.spec_rmsnorm(cfg),
            "attn": L.spec_attention(cfg),
            "ln2": L.spec_rmsnorm(cfg),
            "mlp": L.spec_mlp(cfg),
        }

    def param_specs(self) -> Params:
        cfg = self.cfg
        stacked = tree_map(
            lambda s: ParamSpec((cfg.num_layers,) + s.shape, s.dtype, s.init, s.scale),
            self.block_spec(),
        )
        return {
            "embed": L.spec_embedding(cfg),
            "blocks": stacked,
            "final_norm": L.spec_rmsnorm(cfg),
            "unembed": L.spec_unembed(cfg),
        }

    # -- blocks ---------------------------------------------------------------

    def _block(self, bp: Params, h: torch.Tensor, positions, cache=None, paged_cache_t=None):
        cfg = self.cfg
        a, new_cache, kv = L.attention_block(
            bp["attn"], L.rmsnorm(bp["ln1"], h, cfg.norm_eps), cfg,
            positions=positions, cache=cache, paged_cache_t=paged_cache_t,
        )
        h = h + L.attention_out(bp["attn"], a, cfg)
        h = h + L.mlp(bp["mlp"], L.rmsnorm(bp["ln2"], h, cfg.norm_eps), cfg)
        return h, new_cache, kv

    def _positions(self, b: int, t: int, device) -> torch.Tensor:
        return torch.arange(t, dtype=torch.int32, device=device)[None].expand(b, t)

    # -- public API -------------------------------------------------------------

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal forward -> logits ``[B, T, V]``."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens, cfg)
        pos = self._positions(*tokens.shape, tokens.device)
        for i in range(cfg.num_layers):
            h, _, _ = self._block(_layer(params["blocks"], i), h, pos)
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return L.unembed(params["unembed"], h, cfg, params["embed"])

    def cache_len(self, max_len: int) -> int:
        if self.cfg.sliding_window is not None:
            return min(max_len, self.cfg.sliding_window)
        return max_len

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int) -> Tuple[torch.Tensor, Params]:
        """Process a prompt: (last-position logits ``[B, 1, V]``, cache with
        K/V ``[L, B, cache_len(max_len), Hkv, D]``, zero past the prompt)."""
        cfg = self.cfg
        b, t = tokens.shape
        ct = self.cache_len(max_len)
        if cfg.sliding_window is not None:
            raise NotImplementedError("sliding-window prefill caches are not ported yet")
        if t > ct:
            raise ValueError(f"prefill length {t} exceeds cache capacity {ct}; "
                             "pass a larger max_len")
        h = L.embed(params["embed"], tokens, cfg)
        pos = self._positions(b, t, tokens.device)
        shape = (cfg.num_layers, b, ct, cfg.num_kv_heads, cfg.resolved_head_dim)
        ks = torch.zeros(shape, dtype=L.cdtype(cfg), device=tokens.device)
        vs = torch.zeros_like(ks)
        for i in range(cfg.num_layers):
            h, _, (k, v) = self._block(_layer(params["blocks"], i), h, pos)
            ks[i, :, :t] = k
            vs[i, :, :t] = v
        h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        seq = torch.tensor(t, dtype=torch.int32, device=tokens.device)
        return logits, {"layers": {"k": ks, "v": vs}, "len": seq, "pos": seq.clone()}

    # -- paged slot pool --------------------------------------------------------

    def init_paged_cache(
        self, num_blocks: int, block_size: int, num_slots: int, device: Device = None
    ) -> Params:
        """Zeroed page pool: K/V ``[L, N, bs, Hkv, D]`` in ``compute_dtype``,
        per-slot ``len``/``pos``.  Block 0 is the scratch block."""
        cfg = self.cfg
        dev = resolve_device(device)
        kv = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = L.cdtype(cfg)
        return {
            "layers": {"k": torch.zeros(kv, dtype=dt, device=dev),
                       "v": torch.zeros(kv, dtype=dt, device=dev)},
            "len": torch.zeros(num_slots, dtype=torch.int32, device=dev),
            "pos": torch.zeros(num_slots, dtype=torch.int32, device=dev),
        }

    def write_slot_paged(self, pool: Params, cache: Params, slot: int,
                         table: torch.Tensor) -> Params:
        """Scatter a batch-1 prefill cache into the blocks of ``table``
        (``[W]`` block ids), in place.  Rows past the prefill are written as
        zeros, so a recycled block keeps nothing of its previous owner."""
        k1, pk = cache["layers"]["k"], pool["layers"]["k"]
        if k1.shape[1] != 1:
            raise ValueError(f"write_slot_paged expects a batch-1 cache, got {tuple(k1.shape)}")
        nl, _, t1, h, d = k1.shape
        bs, w = pk.shape[2], table.shape[0]
        if t1 > w * bs:
            raise ValueError(f"prefill cache has {t1} rows but the table holds "
                             f"{w} blocks x {bs} = {w * bs}")
        idx = table.long()
        for name in ("k", "v"):
            src = cache["layers"][name][:, 0]
            blocks = torch.zeros((nl, w * bs, h, d), dtype=pk.dtype, device=pk.device)
            blocks[:, :t1] = src
            pool["layers"][name][:, idx] = blocks.reshape(nl, w, bs, h, d)
        pool["len"][slot] = cache["len"]
        pool["pos"][slot] = cache["pos"]
        return pool

    def reset_slot(self, pool: Params, slot: int) -> Params:
        """Retire ``slot``: zero its counters (its table goes to scratch on
        the host)."""
        pool["len"][slot] = 0
        pool["pos"][slot] = 0
        return pool

    def decode_step_paged(
        self, params: Params, cache: Params, tokens: torch.Tensor,
        block_tables: torch.Tensor, *, cache_t: int,
    ) -> Tuple[torch.Tensor, Params]:
        """One paged token step: tokens ``[S, 1]`` -> (logits ``[S, 1, V]``,
        cache').  ``block_tables`` ``[S, W]`` int32 on the cache's device;
        ``cache_t`` is the logical per-slot row count."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens, cfg)
        pos = cache["pos"][:, None]
        layers = cache["layers"]
        for i in range(cfg.num_layers):
            layer_cache = {"k": layers["k"][i], "v": layers["v"][i],
                           "len": cache["len"], "tables": block_tables}
            h, _, _ = self._block(_layer(params["blocks"], i), h, pos,
                                  cache=layer_cache, paged_cache_t=cache_t)
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        return logits, {"layers": layers, "len": cache["len"] + 1, "pos": cache["pos"] + 1}
