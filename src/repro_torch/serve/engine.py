"""Serving engines (port of the reference's ``repro.serve.engine``):
``sample_token``; the lockstep ``ServeEngine`` (one prefill, then
synchronized decode) for models with a constant-size state cache (the ssm
family); and ``ContinuousBatchingEngine`` on the paged layout, with
quantized page pools, the shared-prefix cache, chunked prefill and
preemption, for the attention family.

One ``step()`` tick of the continuous engine::

    admit:    pending -> free slot.  Monolithic: allocate blocks, prefill
              (batch 1), write_slot_paged, sample token 0.  Chunked (a
              prefix cache or a chunk budget): adopt the trie's cached
              prefix blocks and queue the rest of the prompt for staging
    prefill:  chunked only — this tick's prompt-token budget flows through
              the staging slots in power-of-two chunks (``prefill`` then
              ``prefill_extend`` into a linear staging cache); a finished
              prompt gets fresh blocks, is written into the pool, indexed
              in the trie, and samples token 0
    upkeep:   every active slot whose next KV row opens a block gets one;
              on exhaustion cold trie leaves are evicted first, then the
              latest-admitted slot is preempted (requeued at the front
              with its tokens kept)
    decode:   one decode_step_paged over all S slots [S, 1] -> [S, 1, V],
              sample one token per active slot
    retire:   finished slots release their blocks; their tables go back to
              the scratch block and their counters to 0

Sampling at temperature > 0 runs the STAR softmax through
``ops.softmax`` (``ops.use(softmax="pallas")`` selects the Hopper kernels),
one batched call over the active slots' rows per tick, then a categorical
draw from each request's own seeded ``torch.Generator``, so a request's
draws depend neither on its co-tenants nor on preemption.  The draws are not
the reference's ``jax.random`` draws.

A fault in the config's softmax spec (``FaultModel``) degrades every STAR
softmax of the model, attention rows and sampling alike.  With
``ContinuousConfig.guard`` set, one ``AccuracyGuard`` per engine holds every
sampling softmax to the exact oracle, falls back to the clean ``reference``
backend on a trip, and reports its counters in ``stats()["guard"]``.

Not ported yet: the dense per-slot layout (and so the lockstep engine for
attention models), ring (sliding-window) caches, tracing and the transfer
counters.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvquant import validate_kv_dtype
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.ops.platform import Device, resolve_device
from repro_torch.serve.paged import SCRATCH_BLOCK, BlockPool, PrefixCache, bucket_blocks
from repro_torch.serve.scheduler import Request, Slot, SlotScheduler


def sample_token(
    logits: torch.Tensor,  # [..., V]
    generators: Sequence[torch.Generator],  # one per row of logits
    cfg: ModelConfig,
    temperature: float,
    guard: Optional[ops.AccuracyGuard] = None,
    star_sampling: bool = True,
) -> torch.Tensor:
    """Greedy (``temperature <= 0``: argmax) or temperature sampling:
    probabilities from one ``ops.softmax`` over ``logits / T`` with the
    config's softmax spec (the STAR engine unless its kind is exact or
    ``star_sampling`` is off; held to the exact oracle by ``guard`` when
    given), then one categorical draw per row from that row's generator."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    spec = cfg.softmax_spec
    if spec.kind == "exact" or not star_sampling:
        probs = torch.softmax(scaled, dim=-1)
    else:
        probs = ops.softmax(scaled, spec, guard=guard)
    rows = probs.reshape(-1, probs.shape[-1])
    if rows.shape[0] != len(generators):
        raise ValueError(f"{rows.shape[0]} rows but {len(generators)} generators")
    out = torch.stack([torch.multinomial(r, 1, generator=g)[0] for r, g in zip(rows, generators)])
    return out.to(torch.int32).reshape(probs.shape[:-1])


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0  # 0 = greedy
    star_sampling: bool = True  # STAR softmax on the output distribution


class ServeEngine:
    """Lockstep batch engine: one prefill, then synchronized decode, on
    ``device`` (the card unless ``device="cpu"``); ``params`` must live
    there.  Batch row ``i`` samples from its own ``torch.Generator`` seeded
    ``seed + i`` (not the reference's ``jax.random`` draws: greedy tokens
    are the parity oracle)."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, Any],
                 serve_cfg: ServeConfig = ServeConfig(), *, device: Device = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on {self.device}")
        self.cfg = model_cfg
        self.params = params
        self.serve_cfg = serve_cfg
        self.model = build_model(model_cfg)
        if isinstance(self.model, DecoderLM):
            raise NotImplementedError(
                "the lockstep engine needs the dense per-slot KV layout for attention "
                "models, which is not ported yet (ROADMAP A.2); serve "
                f"{model_cfg.family!r} models with ContinuousBatchingEngine")
        self.seed = seed

    def generate(self, prompts, num_tokens: int):
        """prompts ``[B, T]`` -> (generated ``[B, num_tokens]`` int32,
        ``{"cache_len": ...}``)."""
        prompts = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
        sc = self.serve_cfg
        gens = [torch.Generator(device=self.device).manual_seed(self.seed + i)
                for i in range(prompts.shape[0])]

        def sample(logits):
            return sample_token(logits[:, -1], gens, self.cfg, sc.temperature,
                                star_sampling=sc.star_sampling)[:, None]

        with torch.no_grad():
            logits, cache = self.model.prefill(self.params, prompts, sc.max_len)
            outs = [sample(logits)]
            for _ in range(num_tokens - 1):
                logits, cache = self.model.decode_step(self.params, cache, outs[-1])
                outs.append(sample(logits))
        return torch.cat(outs, dim=1), {"cache_len": int(cache["len"])}


@dataclasses.dataclass
class ContinuousConfig:
    num_slots: int = 8
    max_len: int = 512  # per-slot capacity (prompt + generation)
    temperature: float = 0.0  # 0 = greedy
    kv_block_size: int = 16
    # usable blocks (scratch excluded); None = num_slots * ceil(cache_len / bs)
    kv_pool_blocks: Optional[int] = None
    # shared-prefix KV cache: a radix trie over block-size token chunks
    prefix_cache: bool = False
    # chunked prefill: prompt tokens prefilled per tick (None: monolithic)
    prefill_chunk_tokens: Optional[int] = None
    # page-pool storage: fp32 (compute dtype) | int8 | fp8_e4m3
    kv_dtype: str = "fp32"
    # accuracy guard on the sampling softmax: sampled comparison against the
    # exact oracle, fallback to a clean backend; counters in stats()["guard"]
    guard: Optional[ops.GuardConfig] = None


@dataclasses.dataclass
class TokenEvent:
    uid: int
    token: int
    index: int  # 0-based position within the request's generation
    finished: bool


class ContinuousBatchingEngine:
    """Slot-pool serving over a paged KV cache on ``device`` (the card
    unless ``device="cpu"``); ``params`` must live there."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: Dict[str, Any],
        cb_cfg: ContinuousConfig = ContinuousConfig(),
        *,
        device: Device = None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on {self.device}")
        validate_kv_dtype(cb_cfg.kv_dtype)
        if cb_cfg.prefill_chunk_tokens is not None and cb_cfg.prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got {cb_cfg.prefill_chunk_tokens}")
        self.cfg = model_cfg
        self.params = params
        self.cb = cb_cfg
        self.model = build_model(model_cfg)
        if not isinstance(self.model, DecoderLM):
            raise ValueError(
                "continuous batching needs the per-slot KV-cache pool, which only "
                f"attention-family models implement (got {model_cfg.family!r})")
        self.metrics = MetricsRegistry()
        reg = self.metrics
        self._m_tokens = reg.counter("serve.tokens.generated")
        self._m_finished = reg.counter("serve.requests.finished")
        self._m_prefills = reg.counter(
            "serve.prefill.calls", "model prefill / prefill_extend calls (one per chunk)")
        self._m_preempted = reg.counter(
            "serve.requests.preempted", "requests evicted on pool exhaustion and requeued")
        self._h_ttft = reg.histogram("serve.ttft_s", "submit -> first token")
        self._h_itl = reg.histogram("serve.itl_s", "inter-token latency")
        self._h_queue = reg.histogram("serve.queue_wait_s", "pending-queue wait per stint")
        self.scheduler = SlotScheduler(cb_cfg.num_slots)
        self._cache_t = self.model.cache_len(cb_cfg.max_len)
        bs = cb_cfg.kv_block_size
        self._slot_blocks = -(-self._cache_t // bs)  # table width W
        usable = cb_cfg.kv_pool_blocks
        if usable is None:
            usable = cb_cfg.num_slots * self._slot_blocks
        self.block_pool = BlockPool(usable + 1, bs, kv_dtype=cb_cfg.kv_dtype,
                                    metrics=self.metrics)
        self.pool = self.model.init_paged_cache(usable + 1, bs, cb_cfg.num_slots,
                                                device=self.device, kv_dtype=cb_cfg.kv_dtype)
        self.prefix = (PrefixCache(self.block_pool, metrics=self.metrics)
                       if cb_cfg.prefix_cache else None)
        # either flag routes admission through the staging path
        self._chunked = cb_cfg.prefill_chunk_tokens is not None or cb_cfg.prefix_cache
        self._staging: Dict[int, Dict[str, Any]] = {}
        self._tables = np.full((cb_cfg.num_slots, self._slot_blocks), SCRATCH_BLOCK, np.int32)
        self._rows = np.zeros(cb_cfg.num_slots, np.int64)  # KV rows written per slot
        self._inputs = np.zeros((cb_cfg.num_slots, 1), np.int32)  # next token per slot
        self._seed = seed
        self._generators: Dict[int, torch.Generator] = {}
        # one guard for the engine's lifetime: counters accumulate and the
        # trip latch persists across ticks
        self.guard = ops.AccuracyGuard(cb_cfg.guard) if cb_cfg.guard is not None else None
        self.ticks = 0
        self.preemptions = 0
        self.peak_used_blocks = 0

    # -- submission -------------------------------------------------------------

    def submit(self, prompt: Sequence[int] | np.ndarray, max_new_tokens: int) -> int:
        """Queue a request (never blocks); returns its uid."""
        need = len(prompt) + max_new_tokens - 1
        if need > self.cb.max_len:
            raise ValueError(
                f"request needs {need} cache rows (prompt {len(prompt)} + "
                f"{max_new_tokens} new tokens) but the pool was built with "
                f"max_len={self.cb.max_len}"
            )
        blocks = self.block_pool.blocks_for_tokens(need)
        if blocks > self.block_pool.usable_blocks:
            # larger than the whole pool: no preemption could ever fit it
            raise ValueError(
                f"request needs {blocks} KV blocks but the pool only has "
                f"{self.block_pool.usable_blocks}; raise kv_pool_blocks"
            )
        uid = self.scheduler.submit(prompt, max_new_tokens)
        req = self.scheduler.pending[-1]
        req.submit_time = req.enqueued_at = time.perf_counter()
        return uid

    # -- helpers ----------------------------------------------------------------

    def _generator(self, req: Request) -> torch.Generator:
        # per-request stream, independent of slot placement, co-tenants and
        # preemption (it lives until the request finishes)
        g = self._generators.get(req.uid)
        if g is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(self._seed * 1_000_003 + req.uid)
            self._generators[req.uid] = g
        return g

    def _emit(self, slot: Slot, token: int, finished: bool) -> TokenEvent:
        req = slot.request
        index = len(req.generated_prefix) + len(slot.generated) - 1
        ev = TokenEvent(req.uid, token, index, finished)
        now = time.perf_counter()
        if req.first_token_time is None:
            self._h_ttft.observe(now - req.submit_time)
            req.first_token_time = now
        else:
            self._h_itl.observe(now - req.last_token_time)
        req.last_token_time = now
        self._m_tokens.inc()
        return ev

    def _record(self, slot: Slot, tok: int, events: List[TokenEvent]) -> None:
        finished = self.scheduler.record_token(slot, tok)
        events.append(self._emit(slot, tok, finished))
        self._inputs[slot.index, 0] = tok
        if finished:
            self._finish(slot)

    def _sample_first(self, slot: Slot, logits: torch.Tensor, events: List[TokenEvent]) -> None:
        tok = sample_token(logits[0, -1], [self._generator(slot.request)], self.cfg,
                           self.cb.temperature, guard=self.guard)
        self._record(slot, int(tok), events)

    def _observe_queue_wait(self, req: Request) -> None:
        # consume the stamp: a later preemption opens a new stint
        if req.enqueued_at is not None:
            self._h_queue.observe(time.perf_counter() - req.enqueued_at)
            req.enqueued_at = None

    def _clear_slot(self, slot: Slot) -> None:
        self._tables[slot.index, :] = SCRATCH_BLOCK
        self.model.reset_slot(self.pool, slot.index)

    def _finish(self, slot: Slot) -> None:
        req = self.scheduler.retire(slot)
        self._generators.pop(req.uid, None)
        self.block_pool.release(req.uid)
        self._clear_slot(slot)
        self._m_finished.inc()

    def _note_peak(self) -> None:
        self.peak_used_blocks = max(self.peak_used_blocks, self.block_pool.used_blocks)

    def _tokens(self, req: Request) -> np.ndarray:
        """What a (re-)admission prefills: the prompt plus any tokens the
        request generated before a preemption."""
        if req.generated_prefix:
            return np.concatenate([req.prompt, np.asarray(req.generated_prefix, np.int32)])
        return np.asarray(req.prompt, np.int32)

    # -- block management and preemption ------------------------------------------

    def _preempt(self, slot: Slot) -> None:
        """Evict ``slot``'s request: release its blocks and requeue it at
        the front with its generated tokens; on re-admission it re-prefills
        ``prompt + generated_prefix`` and resumes."""
        self._staging.pop(slot.index, None)
        req = self.scheduler.preempt(slot)
        if req.uid in self.block_pool.owners():  # a staging slot may own none yet
            self.block_pool.release(req.uid)
        self._clear_slot(slot)
        self.preemptions += 1
        self._m_preempted.inc()
        if req.enqueued_at is None:  # the previous stint was observed
            req.enqueued_at = time.perf_counter()

    def _lowest_priority_victim(self, min_uid: int) -> Optional[Slot]:
        """The occupied slot with the largest uid above ``min_uid``: the
        latest-admitted work is evicted first (FIFO priority)."""
        victims = [s for s in self.scheduler.occupied_slots if s.request.uid > min_uid]
        return max(victims, key=lambda s: s.request.uid) if victims else None

    def _reclaim_blocks(self, n: int, min_uid: int) -> bool:
        """Make ``n`` blocks allocatable: evict cold trie leaves first, then
        preempt later-admitted slots.  False when neither frees enough."""
        while not self.block_pool.can_allocate(n):
            if self.prefix is not None and self.prefix.evict_one():
                continue
            victim = self._lowest_priority_victim(min_uid)
            if victim is None:
                return False
            self._preempt(victim)
        return True

    def _admit_blocks(self, slot: Slot, rows: int) -> bool:
        """Allocate the admission table for ``rows`` prefill rows,
        preempting on exhaustion; False (request requeued) if it cannot fit."""
        req = slot.request
        n = self.block_pool.blocks_for_tokens(rows)
        if not self._reclaim_blocks(n, req.uid):
            self.scheduler.pending.appendleft(slot.release())
            return False
        blocks = self.block_pool.allocate(req.uid, n)
        self._tables[slot.index, :] = SCRATCH_BLOCK
        self._tables[slot.index, :n] = blocks
        self._note_peak()
        return True

    def _ensure_decode_block(self, slot: Slot) -> bool:
        """Grow the slot's table when this tick's KV write opens a block;
        preempt on exhaustion (the slot itself when it is the
        lowest-priority occupant).  False if the slot was evicted."""
        rows = int(self._rows[slot.index])
        bs = self.block_pool.block_size
        if rows % bs != 0:
            return True
        while not self.block_pool.can_allocate(1):
            if self.prefix is not None and self.prefix.evict_one():
                continue
            victim = self._lowest_priority_victim(-1)
            if victim is None or victim is slot:
                self._preempt(slot)
                return False
            self._preempt(victim)
        self._tables[slot.index, rows // bs] = self.block_pool.append(slot.request.uid)
        self._note_peak()
        return True

    # -- monolithic admission -----------------------------------------------------

    def _admit(self, slot: Slot, events: List[TokenEvent]) -> None:
        """Allocate the slot's blocks, prefill its prompt, write the KV rows
        into the pool and sample the next token."""
        req = slot.request
        tokens = self._tokens(req)
        rows = len(tokens)
        if not self._admit_blocks(slot, rows):
            return  # pool full even after preemption: wait in line
        self._observe_queue_wait(req)
        bs = self.block_pool.block_size
        # the prefill cache spans the bucketed block grid; grid rows past
        # the allocated blocks land in the scratch block
        width = bucket_blocks(self.block_pool.blocks_for_tokens(rows), self._slot_blocks)
        t = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)[None]
        logits, cache1 = self.model.prefill(self.params, t, width * bs)
        self._m_prefills.inc()
        table = torch.as_tensor(self._tables[slot.index, :width], device=self.device)
        self.model.write_slot_paged(self.pool, cache1, slot.index, table)
        self._rows[slot.index] = rows
        self._sample_first(slot, logits, events)

    # -- chunked prefill and the prefix cache -------------------------------------

    def _staging_rows(self, rows: int) -> int:
        """Linear staging-cache capacity: the bucketed admission block grid
        (the same widths as the monolithic write)."""
        nb = bucket_blocks(self.block_pool.blocks_for_tokens(rows), self._slot_blocks)
        return nb * self.block_pool.block_size

    def _admit_staging(self, slot: Slot) -> None:
        """Bind an admitted request to the chunked path: adopt any cached
        prefix blocks (their prefill is skipped) and queue the rest of the
        prompt for ``_run_prefill_chunks``."""
        req = slot.request
        tokens = self._tokens(req)
        p0, shared = 0, []
        if self.prefix is not None:
            shared, p0 = self.prefix.lookup(tokens)
            if shared:
                self.block_pool.adopt(req.uid, shared)
        self._staging[slot.index] = {
            "req": req, "tokens": tokens, "rows": len(tokens), "p0": p0,
            "shared": list(shared), "suffix": tokens[p0:], "done": 0,
            "cache": None, "logits": None, "Ts": self._staging_rows(len(tokens)),
        }
        slot.prefilling = True
        self._observe_queue_wait(req)

    def _run_prefill_chunks(self) -> List[TokenEvent]:
        """Feed this tick's prompt-token budget through the staging slots
        (FIFO by uid, power-of-two chunks); finished prefills are written
        into the pool and sample their first token."""
        events: List[TokenEvent] = []
        budget = self.cb.prefill_chunk_tokens or (1 << 30)
        for idx in sorted(self._staging, key=lambda i: self._staging[i]["req"].uid):
            if budget <= 0:
                break
            st = self._staging.get(idx)
            if st is None:
                continue  # preempted by an earlier completion this tick
            suffix = st["suffix"]
            while budget > 0 and st["done"] < len(suffix):
                c = min(len(suffix) - st["done"], budget)
                c = 1 << (int(c).bit_length() - 1)  # power of two
                chunk = torch.as_tensor(suffix[st["done"]:st["done"] + c],
                                        dtype=torch.int64, device=self.device)[None]
                if st["cache"] is None and st["p0"]:
                    # seed the staging buffer with the cached prefix rows
                    st["cache"] = self.model.gather_prefix_cache(
                        self.pool, st["shared"], st["p0"], st["Ts"])
                if st["cache"] is None:
                    st["logits"], st["cache"] = self.model.prefill(
                        self.params, chunk, self.cb.max_len, cache_t=st["Ts"])
                else:
                    st["logits"], st["cache"] = self.model.prefill_extend(
                        self.params, st["cache"], chunk)
                self._m_prefills.inc()
                st["done"] += c
                budget -= c
            if st["done"] == len(suffix):
                self._finish_prefill(idx, events)
        return events

    def _finish_prefill(self, idx: int, events: List[TokenEvent]) -> None:
        """Write a finished staging prefill into fresh blocks of the pool,
        index its full blocks in the trie and sample the first token; if the
        pool cannot fit the fresh blocks even after eviction and preemption,
        the request goes back to the front of the queue."""
        st = self._staging.pop(idx)
        slot = self.scheduler.slots[idx]
        req, rows = st["req"], st["rows"]
        bp = self.block_pool
        n_real = bp.blocks_for_tokens(rows)
        n_fresh = n_real - len(st["shared"])
        if not self._reclaim_blocks(n_fresh, req.uid):
            self._requeue_staging(slot, st)
            return
        if req.uid in bp.owners():  # adopted a prefix at admission
            fresh = [bp.append(req.uid) for _ in range(n_fresh)]
        else:
            fresh = bp.allocate(req.uid, n_fresh)
        table_row = st["shared"] + fresh
        self._tables[idx, :] = SCRATCH_BLOCK
        self._tables[idx, :n_real] = table_row
        self._note_peak()
        # the adopted prefix rows already live in the pool: their write goes
        # to scratch so shared blocks stay untouched; pad to the bucketed grid
        width = st["Ts"] // bp.block_size
        write_table = ([SCRATCH_BLOCK] * len(st["shared"]) + fresh
                       + [SCRATCH_BLOCK] * (width - n_real))
        self.model.write_slot_paged(
            self.pool, st["cache"], idx,
            torch.as_tensor(write_table, dtype=torch.int32, device=self.device))
        self._rows[idx] = rows
        if self.prefix is not None:
            self.prefix.insert(st["tokens"], table_row)
        slot.prefilling = False
        self._sample_first(slot, st["logits"], events)

    def _requeue_staging(self, slot: Slot, st: Dict[str, Any]) -> None:
        req = st["req"]
        if req.uid in self.block_pool.owners():
            self.block_pool.release(req.uid)  # return adopted prefix blocks
        req.enqueued_at = time.perf_counter()  # admission observed: new stint
        self.scheduler.pending.appendleft(slot.release())
        self._clear_slot(slot)

    # -- the tick -----------------------------------------------------------------

    def step(self) -> List[TokenEvent]:
        """One engine tick: admissions, prefill chunks, block upkeep, then
        one decode over the pool.  Returns the tokens emitted."""
        events: List[TokenEvent] = []
        for slot in self.scheduler.admit():
            if slot.free:
                continue  # preempted by an earlier admission this tick
            if self._chunked:
                self._admit_staging(slot)
            else:
                self._admit(slot, events)
        if self._staging:
            events.extend(self._run_prefill_chunks())
        for slot in sorted(self.scheduler.active_slots, key=lambda s: s.request.uid):
            if not slot.free:
                self._ensure_decode_block(slot)
        active = self.scheduler.active_slots
        if not active:
            return events
        tables = torch.as_tensor(self._tables, device=self.device)
        inputs = torch.as_tensor(self._inputs, dtype=torch.int64, device=self.device)
        logits, self.pool = self.model.decode_step_paged(
            self.params, self.pool, inputs, tables, cache_t=self._cache_t
        )
        for slot in active:
            self._rows[slot.index] += 1
        # one batched sampling softmax over the active rows (one guard check)
        rows = torch.as_tensor([s.index for s in active], device=self.device)
        sampled = sample_token(
            logits[rows, -1], [self._generator(s.request) for s in active],
            self.cfg, self.cb.temperature, guard=self.guard,
        )
        toks = sampled.cpu().numpy()  # the tick's one device -> host transfer
        for slot, tok in zip(active, toks):
            self._record(slot, int(tok), events)
        self.ticks += 1
        return events

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Drive ticks until every submitted request finished; returns
        ``{uid: generated tokens}``."""
        n = 0
        while not self.scheduler.done():
            self.step()
            n += 1
            if max_ticks is not None and n >= max_ticks and not self.scheduler.done():
                raise RuntimeError(f"engine did not drain within {max_ticks} ticks")
        return dict(self.scheduler.finished)

    def serve(self, prompts, max_new_tokens) -> List[List[int]]:
        """Submit all prompts, drain, return the outputs in order."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        uids = [self.submit(p, int(m)) for p, m in zip(prompts, max_new_tokens)]
        done = self.run()
        return [done[u] for u in uids]

    # -- accounting ---------------------------------------------------------------

    def kv_row_bytes(self) -> int:
        """Bytes one KV token row costs across all layers (K + V), from the
        leaves' actual dtypes (one byte per code in a quantized pool)."""
        layers = self.pool["layers"]
        k, v = layers["k"], layers["v"]
        return k.shape[0] * k.shape[3] * k.shape[4] * (k.element_size() + v.element_size())

    def kv_scale_bytes_per_block(self) -> int:
        """Scale-page bytes per block across all layers (0 at fp32)."""
        layers = self.pool["layers"]
        if "k_scale" not in layers:
            return 0
        ks, vs = layers["k_scale"], layers["v_scale"]
        return ks.shape[0] * ks.shape[2] * (ks.element_size() + vs.element_size())

    def kv_stats(self) -> Dict[str, Any]:
        bp = self.block_pool
        bs = bp.block_size
        prefix = None
        if self.prefix is not None:
            p = self.prefix
            prefix = {"hits": p.hits, "tokens_saved": p.tokens_saved,
                      "evicted": p.evicted, "nodes": len(p)}
        # a block's footprint: its token rows plus its scale rows
        block_bytes = bs * self.kv_row_bytes() + self.kv_scale_bytes_per_block()
        return {
            "prefix": prefix,
            "layout": "paged",
            "kv_dtype": bp.kv_dtype,
            "used_blocks": bp.used_blocks,
            "free_blocks": bp.free_blocks,
            "total_blocks": bp.usable_blocks,
            "kv_bytes_per_token": block_bytes / bs,
            "kv_bytes_in_use": bp.used_blocks * block_bytes,
            "kv_bytes_capacity": bp.usable_blocks * block_bytes,
            "peak_kv_bytes": self.peak_used_blocks * block_bytes,
            "preemptions": self.preemptions,
            "peak_used_blocks": self.peak_used_blocks,
        }

    def stats(self) -> Dict[str, Any]:
        """Ticks, KV accounting, the accuracy guard's counters (calls /
        checks / trips / fallbacks / tripped / last_error; None without a
        guard) and the engine's metrics snapshot."""
        return {"ticks": self.ticks, "kv": self.kv_stats(),
                "guard": self.guard.stats() if self.guard is not None else None,
                "metrics": self.metrics.snapshot()}
