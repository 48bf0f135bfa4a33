"""Decoder-only transformer LM: the dense, MoE and VLM families (port of
``repro.models.transformer.DecoderLM``: forward, prefill, chunked
``prefill_extend``, the lockstep decode cache, the dense per-slot pool and
the paged pool over fp32 or quantized pages, and sliding-window rings on
each).  The reference's ``scan`` over stacked layers is a Python loop over
the ``[L]`` axis of the parameter tree.

A MoE block (``layers.moe``) replaces the MLP.  Prefill and chunks given
``moe_capacity`` (the whole prompt's, ``moe_prefill_capacity``) carry the
per-layer expert counts in the cache (``layers["moe"]``, ``[L, B, E]``
int32) so that a chunked prefill drops the tokens a monolithic one drops;
decode is stateless (one token a group: capacity 1, no drop).

The VLM family (qwen2-vl) is the dense backbone behind a stub vision
frontend: ``forward`` and ``prefill`` take ``patch_embeds`` ``[B, P,
frontend_dim]``, project them with ``patch_proj`` in the compute dtype and
prepend them (``_embed_inputs``), with M-RoPE (t, h, w) position ids.  The
cache's ``"len"`` then counts ``P + T`` rows and its ``"pos"`` is the next
temporal position ``side + T``; every later step (chunks, decode) continues
from ``"pos"`` with three equal streams, which M-RoPE rotates exactly as the
1-D rope.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvquant
from repro_torch.distributed.sharding import with_logical_constraint as wlc
from repro_torch.distributed.sharding import replicated_value, zeros_placed
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, layer, stack_specs
from repro_torch.ops.platform import Device, resolve_device

Params = Dict[str, Any]


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM is the dense and moe families and the vlm backbone, "
                             f"got {cfg.family!r}")
        self.cfg = cfg.validate()

    # -- parameters -----------------------------------------------------------

    def block_spec(self) -> Params:
        cfg = self.cfg
        spec = {"ln1": L.spec_rmsnorm(cfg), "attn": L.spec_attention(cfg),
                "ln2": L.spec_rmsnorm(cfg)}
        if cfg.family == "moe":
            spec["moe"] = L.spec_moe(cfg)
        else:
            spec["mlp"] = L.spec_mlp(cfg)
        return spec

    def param_specs(self) -> Params:
        cfg = self.cfg
        specs = {
            "embed": L.spec_embedding(cfg),
            "blocks": stack_specs(self.block_spec(), cfg.num_layers),
            "final_norm": L.spec_rmsnorm(cfg),
            "unembed": L.spec_unembed(cfg),
        }
        if cfg.family == "vlm":  # its leaf is a "kernel": cast once with the others
            specs["patch_proj"] = {"kernel": ParamSpec(
                (cfg.frontend_dim or cfg.d_model, cfg.d_model), ("embed", None), L.pdtype(cfg),
                "fan_in")}
        return specs

    # -- blocks ---------------------------------------------------------------

    def _block(self, bp: Params, h: torch.Tensor, positions, cache=None, paged_cache_t=None,
               moe_capacity: Optional[int] = None, moe_state: Optional[torch.Tensor] = None):
        """One block: ``(h, cache', (k, v), moe counts)``.  The MoE block runs
        stateful (chunk-invariant drops, its counts returned) when given the
        prior counts or a capacity, else bare (counts None)."""
        cfg = self.cfg
        a, new_cache, kv = L.attention_block(
            bp["attn"], L.rmsnorm(bp["ln1"], h, cfg.norm_eps), cfg,
            positions=positions, cache=cache, paged_cache_t=paged_cache_t,
        )
        h = h + L.attention_out(bp["attn"], a, cfg)
        hn = L.rmsnorm(bp["ln2"], h, cfg.norm_eps)
        counts = None
        if cfg.family != "moe":
            h = h + L.mlp(bp["mlp"], hn, cfg)
        elif moe_state is not None or moe_capacity is not None:
            y, counts = L.moe(bp["moe"], hn, cfg, state=moe_state, capacity=moe_capacity)
            h = h + y
        else:
            h = h + L.moe(bp["moe"], hn, cfg)
        return h, new_cache, kv, counts

    def _positions(self, b: int, t: int, device) -> torch.Tensor:
        return torch.arange(t, dtype=torch.int32, device=device)[None].expand(b, t)

    def _streams(self, pos: torch.Tensor) -> torch.Tensor:
        """Positions ``[B, T]`` as the three equal M-RoPE streams ``[B, T,
        3]`` on a config with sections (text rows and decode steps), else as
        they are."""
        return torch.stack([pos, pos, pos], dim=-1) if self.cfg.mrope_sections else pos

    def _embed_inputs(self, params: Params, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor]):
        """``(x, positions)``.  A VLM given ``patch_embeds`` ``[B,
        P, frontend_dim]`` prepends the projected patches (in the compute
        dtype) and builds M-RoPE ids ``[B, P + T, 3]``: patch ``p`` is ``(0,
        p // side, p % side)`` on a stub grid of ``side = max(1, int(P **
        0.5))`` (the reference's float square root, kept as it is), text
        token ``i`` is ``(side + i)`` in all three streams.  Otherwise 1-D
        positions ``[B, T]`` from 0."""
        cfg = self.cfg
        x = L.embed(params["embed"], tokens, cfg)
        b, t = tokens.shape
        dev = tokens.device
        if cfg.family != "vlm" or patch_embeds is None:
            return x, self._positions(b, t, dev)
        dt = L.cdtype(cfg)
        pe = torch.as_tensor(patch_embeds, device=dev)
        patches = L.linear(pe.to(dt), params["patch_proj"]["kernel"].to(dt))
        n_patch = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
        side = max(1, int(n_patch ** 0.5))
        idx = torch.arange(n_patch, dtype=torch.int32, device=dev)
        ppos = torch.stack([torch.zeros_like(idx), idx // side, idx % side], dim=-1)
        text = side + torch.arange(t, dtype=torch.int32, device=dev)
        pos = torch.cat([ppos, torch.stack([text, text, text], dim=-1)], dim=0)
        return x, pos[None].expand(b, n_patch + t, 3)

    # -- public API -------------------------------------------------------------

    def forward(self, params: Params, tokens: torch.Tensor, *,
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence causal forward -> logits ``[B, T (+ P), V]``."""
        cfg = self.cfg
        h, pos = self._embed_inputs(params, tokens, patch_embeds)
        for i in range(cfg.num_layers):
            h = L.remat(cfg, lambda bp, x: self._block(bp, x, pos)[0],
                        layer(params["blocks"], i), h)
            if cfg.seq_parallel_activations:
                # the carry between blocks sharded along its rows over the model
                # dim: the residual each block keeps shrinks by the TP degree
                h = wlc(h, ("batch", "act_seq", "embed"))
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return L.unembed(params["unembed"], h, cfg, params["embed"])

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross entropy: ``batch`` holds ``tokens`` and
        ``labels`` ``[B, T]`` (-1: no loss) and a VLM's ``patch_embeds``,
        whose prefix rows take no loss."""
        logits = self.forward(params, batch["tokens"], patch_embeds=batch.get("patch_embeds"))
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        return L.cross_entropy(logits, labels)

    def cache_len(self, max_len: int) -> int:
        if self.cfg.sliding_window is not None:
            return min(max_len, self.cfg.sliding_window)
        return max_len

    def prefill(self, params: Params, tokens: torch.Tensor, max_len: int, *,
                patch_embeds: Optional[torch.Tensor] = None,
                cache_t: Optional[int] = None,
                moe_capacity: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
        """Process a prompt: (last-position logits ``[B, 1, V]``, cache with
        K/V ``[L, B, ct, Hkv, D]``, zero past the prompt).  ``ct`` is
        ``cache_t`` when given (chunked prefill sizes its linear staging
        buffer so later chunks can append), else ``cache_len(max_len)``.  A
        sliding window shorter than the prompt keeps its last ``ct`` rows in
        ring order (``layers.fit_window_cache``).  ``moe_capacity`` (a MoE
        model) sets the experts' queue capacity and adds the per-layer
        expert counts ``layers["moe"]`` to the cache.  A VLM's
        ``patch_embeds`` prepend ``P`` rows: ``len`` counts ``P + T`` and
        ``pos`` is the next temporal position."""
        cfg = self.cfg
        b = tokens.shape[0]
        h, pos = self._embed_inputs(params, tokens, patch_embeds)
        t = h.shape[1]
        ct = cache_t if cache_t is not None else self.cache_len(max_len)
        if cfg.sliding_window is None and t > ct:
            raise ValueError(f"prefill length {t} (with any patch prefix) exceeds cache "
                             f"capacity {ct}; pass a larger max_len")
        shape = (cfg.num_layers, b, ct, cfg.num_kv_heads, cfg.resolved_head_dim)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        ks = zeros_placed(shape, axes, L.cdtype(cfg), tokens.device)
        vs = zeros_placed(shape, axes, L.cdtype(cfg), tokens.device)
        counts = []
        for i in range(cfg.num_layers):
            h, _, (k, v), c = self._block(layer(params["blocks"], i), h, pos,
                                          moe_capacity=moe_capacity)
            if t > ct:  # a window shorter than the prompt: the rolled last ct rows
                k, v = L.fit_window_cache(k, v, 1, ct, t)
            L.write_rows(ks[i], k, 1)
            L.write_rows(vs[i], v, 1)
            counts.append(c)
        h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        seq = torch.tensor(t, dtype=torch.int32, device=tokens.device)
        # the next rope position: past the patch grid's extent for a VLM
        nxt = (pos[0, -1, 0] + 1).to(torch.int32) if pos.ndim == 3 else seq.clone()
        layers = {"k": ks, "v": vs}
        if counts[0] is not None:
            layers["moe"] = torch.stack(counts)
        return logits, {"layers": layers, "len": seq, "pos": nxt}

    def prefill_extend(self, params: Params, cache: Params, tokens: torch.Tensor, *,
                       moe_capacity: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
        """Append a prompt chunk to a linear staging cache, in place.

        tokens ``[1, c]`` land at rows ``[len, len + c)`` (queries at offset
        ``len``, causal against every cached row), so ``prefill`` plus
        ``prefill_extend`` chunks give the KV rows and final logits of one
        monolithic ``prefill``.  A MoE model continues the cache's expert
        counts (``layers["moe"]``) under ``moe_capacity``, so the chunks
        drop what the monolithic prefill drops.  Returns (last-position
        logits, cache')."""
        cfg = self.cfg
        b, c = tokens.shape
        start = int(cache["len"])
        h = L.embed(params["embed"], tokens, cfg)
        pos = (int(cache["pos"]) + torch.arange(c, dtype=torch.int32, device=tokens.device))
        pos = self._streams(pos[None].expand(b, c))
        layers = cache["layers"]
        prior = layers.get("moe")
        counts = []
        for i in range(cfg.num_layers):
            layer_cache = {"k": layers["k"][i], "v": layers["v"][i], "len": start}
            h, _, _, cnt = self._block(
                layer(params["blocks"], i), h, pos, cache=layer_cache,
                moe_capacity=moe_capacity, moe_state=None if prior is None else prior[i])
            counts.append(cnt)
        # rmsnorm is positionwise: norming the last row alone matches the
        # monolithic norm-then-slice
        h = L.rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        out = {"k": layers["k"], "v": layers["v"]}
        if counts[0] is not None:
            out["moe"] = torch.stack(counts)
        return logits, {"layers": out, "len": cache["len"] + c, "pos": cache["pos"] + c}

    def cache_spec(self, batch: int, max_len: int) -> Params:
        """Spec tree of the lockstep decode cache (the reference's
        ``cache_spec``): K/V ``[L, B, cache_len(max_len), Hkv, D]`` in the
        compute dtype, rows along "kv_seq"; scalar ``len`` / ``pos``."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch, self.cache_len(max_len), cfg.num_kv_heads,
              cfg.resolved_head_dim)
        axes = ("layers", "batch", "kv_seq", "kv_heads", None)
        return {"layers": {"k": ParamSpec(kv, axes, L.cdtype(cfg), "zeros"),
                           "v": ParamSpec(kv, axes, L.cdtype(cfg), "zeros")},
                "len": ParamSpec((), (), torch.int32, "zeros"),
                "pos": ParamSpec((), (), torch.int32, "zeros")}

    # -- dense slot pool (continuous batching) and the lockstep decode ---------

    def init_pool_cache(self, num_slots: int, max_len: int, device: Device = None) -> Params:
        """Zeroed per-slot pool: K/V ``[L, S, T, Hkv, D]`` in ``compute_dtype``
        (``T = cache_len(max_len)``), per-slot ``len`` / ``pos``."""
        cfg = self.cfg
        dev = resolve_device(device)
        kv = (cfg.num_layers, num_slots, self.cache_len(max_len), cfg.num_kv_heads,
              cfg.resolved_head_dim)
        return {
            "layers": {"k": torch.zeros(kv, dtype=L.cdtype(cfg), device=dev),
                       "v": torch.zeros(kv, dtype=L.cdtype(cfg), device=dev)},
            "len": torch.zeros(num_slots, dtype=torch.int32, device=dev),
            "pos": torch.zeros(num_slots, dtype=torch.int32, device=dev),
        }

    def write_slot(self, pool: Params, cache: Params, slot: int) -> Params:
        """Copy a batch-1 prefill cache into pool ``slot``, in place (the
        prefill must have used the pool's ``max_len``, so the rows line up);
        the slot decodes from its own length on the next tick."""
        k1, pk = cache["layers"]["k"], pool["layers"]["k"]
        if k1.shape[1] != 1:
            raise ValueError(f"write_slot expects a batch-1 prefill cache, got {tuple(k1.shape)}")
        if k1.shape[2] != pk.shape[2]:
            raise ValueError(f"prefill cache length {k1.shape[2]} != pool length {pk.shape[2]}; "
                             "prefill with the pool's max_len")
        for name in ("k", "v"):
            pool["layers"][name][:, slot] = cache["layers"][name][:, 0]
        pool["len"][slot] = cache["len"]
        pool["pos"][slot] = cache["pos"]
        return pool

    def finalize_ring_cache(self, cache: Params, wlen: int) -> Params:
        """Fold a linear staging cache into the ring layout (slot = position
        % ``wlen``): ring slot ``s`` takes the latest staged row congruent to
        ``s``, ``j = s + floor((T - 1 - s) / wlen) * wlen`` with ``T`` the
        cache's device ``len``; slots ``s >= T`` clamp to row 0 (masked:
        decode trusts ``min(len, wlen)`` rows).  Only K and V are kept: a
        MoE staging cache's expert counts are dropped, as decode is
        stateless."""
        k = cache["layers"]["k"]
        s = torch.arange(wlen, device=k.device)
        j = torch.clamp(s + ((cache["len"].long() - 1 - s) // wlen) * wlen, 0, k.shape[2] - 1)
        return {"layers": {name: cache["layers"][name].index_select(2, j) for name in ("k", "v")},
                "len": cache["len"], "pos": cache["pos"]}

    def moe_prefill_capacity(self, rows: int) -> Optional[int]:
        """The expert capacity of a ``rows``-row prompt (None for a dense
        model): what every chunk of that prompt must use."""
        if self.cfg.family != "moe":
            return None
        return L.moe_capacity(self.cfg, rows)

    def decode_step(self, params: Params, cache: Params,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Params]:
        """One token step over a lockstep cache (scalar ``len`` / ``pos``)
        or a dense per-slot pool (``[S]`` counters): tokens ``[B, 1]`` ->
        (logits ``[B, 1, V]``, the same cache).  Every state update is in
        place — each row's KV write, then ``len`` and ``pos`` advance by
        one — so a CUDA graph of the step owns the cache.  A MoE block runs
        bare (one token a group: capacity 1)."""
        cfg = self.cfg
        b = tokens.shape[0]
        h = L.embed(params["embed"], tokens, cfg)
        pos = replicated_value(cache["pos"])  # under a mesh: the same value on every rank
        pos = self._streams(pos[:, None] if pos.ndim == 1 else pos.reshape(1, 1).expand(b, 1))
        layers = cache["layers"]
        for i in range(cfg.num_layers):
            layer_cache = {"k": layers["k"][i], "v": layers["v"][i], "len": cache["len"]}
            h = self._block(layer(params["blocks"], i), h, pos, cache=layer_cache)[0]
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        cache["len"].add_(1)
        cache["pos"].add_(1)
        return logits, cache

    # -- paged slot pool --------------------------------------------------------

    def init_paged_cache(
        self, num_blocks: int, block_size: int, num_slots: int, device: Device = None,
        kv_dtype: str = "fp32",
    ) -> Params:
        """Zeroed page pool: K/V ``[L, N, bs, Hkv, D]``, per-slot
        ``len``/``pos``.  Block 0 is the scratch block.  ``kv_dtype`` fp32
        stores values in ``compute_dtype``; int8 / fp8_e4m3 store codes and
        add ``k_scale`` / ``v_scale`` ``[L, N, Hkv]`` float32 leaves set to
        ones, so never-written pages decode to zeros."""
        cfg = self.cfg
        dev = resolve_device(device)
        kvquant.validate_kv_dtype(kv_dtype)
        kv = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = L.cdtype(cfg) if kv_dtype == "fp32" else kvquant.storage_dtype(kv_dtype)
        leaves = {"k": torch.zeros(kv, dtype=dt, device=dev),
                  "v": torch.zeros(kv, dtype=dt, device=dev)}
        if kv_dtype != "fp32":
            sc = (cfg.num_layers, num_blocks, cfg.num_kv_heads)
            leaves["k_scale"] = torch.ones(sc, dtype=torch.float32, device=dev)
            leaves["v_scale"] = torch.ones(sc, dtype=torch.float32, device=dev)
        return {
            "layers": leaves,
            "len": torch.zeros(num_slots, dtype=torch.int32, device=dev),
            "pos": torch.zeros(num_slots, dtype=torch.int32, device=dev),
        }

    def write_slot_paged(self, pool: Params, cache: Params, slot: int,
                         table: torch.Tensor) -> Params:
        """Scatter a batch-1 prefill cache into the blocks of ``table``
        (``[W]`` block ids), in place.  Rows past the prefill are written as
        zeros, so a recycled block keeps nothing of its previous owner.  A
        quantized pool quantizes whole blocks (each block's scale is the
        absmax over its rows: no clipping on this path)."""
        k1, pk = cache["layers"]["k"], pool["layers"]["k"]
        if k1.shape[1] != 1:
            raise ValueError(f"write_slot_paged expects a batch-1 cache, got {tuple(k1.shape)}")
        nl, _, t1, h, d = k1.shape
        bs, w = pk.shape[2], table.shape[0]
        if t1 > w * bs:
            raise ValueError(f"prefill cache has {t1} rows but the table holds "
                             f"{w} blocks x {bs} = {w * bs}")
        idx = table.long()
        kv_dtype = kvquant.dtype_of(pk.dtype)
        layers = pool["layers"]
        for name in ("k", "v"):
            src = cache["layers"][name][:, 0]
            blocks = torch.zeros((nl, w * bs, h, d), dtype=src.dtype, device=pk.device)
            blocks[:, :t1] = src
            blocks = blocks.reshape(nl, w, bs, h, d)
            if kv_dtype == "fp32":
                layers[name][:, idx] = blocks.to(pk.dtype)
            else:
                codes, scale = kvquant.quantize_blocks(blocks, kv_dtype)
                kvquant.indexable(layers[name])[:, idx] = kvquant.indexable(codes)
                layers[f"{name}_scale"][:, idx] = scale
        pool["len"][slot] = cache["len"]
        pool["pos"][slot] = cache["pos"]
        return pool

    def copy_block(self, pool: Params, src: int, dst: int) -> Params:
        """Copy one KV block, all layers, in place — the device half of the
        allocator's copy-on-write (``BlockPool.ensure_writable``); a
        quantized pool's scale rows move with their block."""
        for leaf in pool["layers"].values():
            leaf[:, dst] = leaf[:, src]
        return pool

    def gather_prefix_cache(self, pool: Params, blocks: Sequence[int], rows: int,
                            capacity: int) -> Params:
        """Batch-1 linear staging cache ``[L, 1, capacity, Hkv, D]`` seeded
        from the cached prefix ``blocks`` (``rows == len(blocks) * bs``), in
        ``compute_dtype``; a quantized pool's blocks are dequantized through
        their own scale rows (``kvquant.decode``).  Rows past ``rows`` are
        zero until ``prefill_extend`` writes them."""
        layers = pool["layers"]
        pk = layers["k"]
        bs = pk.shape[2]
        if rows != len(blocks) * bs:
            raise ValueError(f"prefix rows {rows} != {len(blocks)} blocks x {bs}")
        tab = torch.as_tensor(list(blocks), dtype=torch.long, device=pk.device)
        dt = L.cdtype(self.cfg)
        out = {}
        for name in ("k", "v"):
            g = kvquant.indexable(layers[name])[:, tab].view(pk.dtype)
            if f"{name}_scale" in layers:
                g = kvquant.decode(g, layers[f"{name}_scale"][:, tab][:, :, None, :, None])
            nl, nb, _, hh, dd = g.shape
            buf = torch.zeros((nl, 1, capacity, hh, dd), dtype=dt, device=pk.device)
            buf[:, 0, :rows] = g.reshape(nl, nb * bs, hh, dd).to(dt)
            out[name] = buf
        seq = torch.tensor(rows, dtype=torch.int32, device=pk.device)
        return {"layers": out, "len": seq, "pos": seq.clone()}

    def reset_slot(self, pool: Params, slot: int) -> Params:
        """Retire ``slot`` of a dense or paged pool: zero its counters (a
        paged slot's table goes to scratch on the host).  A free slot's
        counters regrow with every tick; the scheduler, not ``len``, owns
        occupancy."""
        pool["len"][slot] = 0
        pool["pos"][slot] = 0
        return pool

    def decode_step_paged(
        self, params: Params, cache: Params, tokens: torch.Tensor,
        block_tables: torch.Tensor, *, cache_t: int,
    ) -> Tuple[torch.Tensor, Params]:
        """One paged token step: tokens ``[S, 1]`` -> (logits ``[S, 1, V]``,
        the same cache).  ``block_tables`` ``[S, W]`` int32 on the cache's
        device; ``cache_t`` is the logical per-slot row count.  Every state
        update is in place — the KV rows, then ``len`` and ``pos`` advance by
        one in the pool's own tensors — so a CUDA graph of the step owns the
        pool's state (the reference returns new arrays)."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens, cfg)
        pos = self._streams(cache["pos"][:, None])
        layers = cache["layers"]
        for i in range(cfg.num_layers):
            layer_cache = {name: leaf[i] for name, leaf in layers.items()}
            layer_cache.update(len=cache["len"], tables=block_tables)
            h = self._block(layer(params["blocks"], i), h, pos,
                            cache=layer_cache, paged_cache_t=cache_t)[0]
        h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = L.unembed(params["unembed"], h, cfg, params["embed"])
        cache["len"].add_(1)
        cache["pos"].add_(1)
        return logits, cache
