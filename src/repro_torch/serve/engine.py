"""Continuous-batching serving over the paged KV cache (port of the
reference's ``repro.serve.engine``: ``sample_token`` and
``ContinuousBatchingEngine`` on the paged layout).

One ``step()`` tick::

    admit:   pending -> free slot: allocate blocks, prefill(batch=1),
             write_slot_paged into the page pool, sample token 0
    decode:  grow tables that cross a block boundary, one
             decode_step_paged over all S slots [S, 1] -> [S, 1, V],
             sample one token per active slot
    retire:  finished slots release their blocks; their tables go back to
             the scratch block and their counters to 0

Sampling at temperature > 0 runs the STAR softmax through
``ops.softmax`` (``ops.use(softmax="pallas")`` selects the Triton kernel),
then a categorical draw from the request's own seeded ``torch.Generator``,
so a request's draws do not depend on its co-tenants.  The draws are not
the reference's ``jax.random`` draws.

Not ported yet: the dense per-slot layout and the lockstep engine, prefix
cache and chunked prefill, quantized KV, the accuracy guard and preemption
— pool exhaustion raises :class:`PoolExhausted` instead of preempting.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.ops.platform import Device, resolve_device
from repro_torch.serve.paged import SCRATCH_BLOCK, BlockPool, bucket_blocks
from repro_torch.serve.scheduler import Request, Slot, SlotScheduler


def sample_token(
    logits: torch.Tensor,  # [..., V]
    generators: Sequence[Optional[torch.Generator]],  # one per row of logits
    cfg: ModelConfig,
    temperature: float,
) -> torch.Tensor:
    """Greedy (``temperature <= 0``: argmax) or temperature sampling:
    probabilities from one ``ops.softmax`` over ``logits / T`` with the
    config's softmax spec (the STAR engine unless its kind is exact), then
    one categorical draw per row from that row's generator (rows whose
    generator is None — free slots — get token 0)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    spec = cfg.softmax_spec
    probs = torch.softmax(scaled, dim=-1) if spec.kind == "exact" else ops.softmax(scaled, spec)
    rows = probs.reshape(-1, probs.shape[-1])
    if rows.shape[0] != len(generators):
        raise ValueError(f"{rows.shape[0]} rows but {len(generators)} generators")
    out = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for i, g in enumerate(generators):
        if g is not None:
            out[i] = torch.multinomial(rows[i], 1, generator=g)[0]
    return out.to(torch.int32).reshape(probs.shape[:-1])


@dataclasses.dataclass
class ContinuousConfig:
    num_slots: int = 8
    max_len: int = 512  # per-slot capacity (prompt + generation)
    temperature: float = 0.0  # 0 = greedy
    kv_block_size: int = 16
    # usable blocks (scratch excluded); None = num_slots * ceil(cache_len / bs)
    kv_pool_blocks: Optional[int] = None


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
        self.cfg = model_cfg
        self.params = params
        self.cb = cb_cfg
        self.model = build_model(model_cfg)
        self.metrics = MetricsRegistry()
        reg = self.metrics
        self._m_tokens = reg.counter("serve.tokens.generated")
        self._m_finished = reg.counter("serve.requests.finished")
        self._h_ttft = reg.histogram("serve.ttft_s", "submit -> first token")
        self._h_itl = reg.histogram("serve.itl_s", "inter-token latency")
        self._h_queue = reg.histogram("serve.queue_wait_s", "pending-queue wait")
        self.scheduler = SlotScheduler(cb_cfg.num_slots)
        self._cache_t = self.model.cache_len(cb_cfg.max_len)
        bs = cb_cfg.kv_block_size
        self._slot_blocks = -(-self._cache_t // bs)  # table width W
        usable = cb_cfg.kv_pool_blocks
        if usable is None:
            usable = cb_cfg.num_slots * self._slot_blocks
        self.block_pool = BlockPool(usable + 1, bs)
        self.pool = self.model.init_paged_cache(usable + 1, bs, cb_cfg.num_slots,
                                                device=self.device)
        self._tables = np.full((cb_cfg.num_slots, self._slot_blocks), SCRATCH_BLOCK, np.int32)
        self._rows = np.zeros(cb_cfg.num_slots, np.int64)  # KV rows written per slot
        self._inputs = np.zeros((cb_cfg.num_slots, 1), np.int32)  # next token per slot
        self._seed = seed
        self._generators: Dict[int, torch.Generator] = {}
        self.ticks = 0
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
        # per-request stream, independent of slot placement and co-tenants
        g = self._generators.get(req.uid)
        if g is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(self._seed * 1_000_003 + req.uid)
            self._generators[req.uid] = g
        return g

    def _emit(self, slot: Slot, token: int, finished: bool) -> TokenEvent:
        req = slot.request
        ev = TokenEvent(req.uid, token, len(slot.generated) - 1, finished)
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

    def _finish(self, slot: Slot) -> None:
        req = self.scheduler.retire(slot)
        self._generators.pop(req.uid, None)
        self.block_pool.release(req.uid)
        self._tables[slot.index, :] = SCRATCH_BLOCK
        self.model.reset_slot(self.pool, slot.index)
        self._m_finished.inc()

    def _note_peak(self) -> None:
        self.peak_used_blocks = max(self.peak_used_blocks, self.block_pool.used_blocks)

    def _admit(self, slot: Slot, events: List[TokenEvent]) -> None:
        """Allocate the slot's blocks, prefill its prompt, write the KV rows
        into the pool and sample the first token."""
        req = slot.request
        bp = self.block_pool
        rows = len(req.prompt)
        n = bp.blocks_for_tokens(rows)
        blocks = bp.allocate(req.uid, n)  # PoolExhausted: no preemption yet
        self._tables[slot.index, :] = SCRATCH_BLOCK
        self._tables[slot.index, :n] = blocks
        self._note_peak()
        now = time.perf_counter()
        self._h_queue.observe(now - req.enqueued_at)
        # the prefill cache spans the bucketed block grid; grid rows past
        # the allocated blocks land in the scratch block
        width = bucket_blocks(n, self._slot_blocks)
        tokens = torch.as_tensor(req.prompt, dtype=torch.int64, device=self.device)[None]
        logits, cache1 = self.model.prefill(self.params, tokens, width * bp.block_size)
        table = torch.as_tensor(self._tables[slot.index, :width], device=self.device)
        self.model.write_slot_paged(self.pool, cache1, slot.index, table)
        self._rows[slot.index] = rows
        tok = sample_token(logits[0, -1], [self._generator(req)], self.cfg, self.cb.temperature)
        self._record(slot, int(tok), events)

    def _ensure_decode_block(self, slot: Slot) -> None:
        """Grow the slot's table when this tick's KV write opens a block."""
        rows = int(self._rows[slot.index])
        bs = self.block_pool.block_size
        if rows % bs == 0:
            blk = self.block_pool.append(slot.request.uid)  # PoolExhausted
            self._tables[slot.index, rows // bs] = blk
            self._note_peak()

    # -- the tick -----------------------------------------------------------------

    def step(self) -> List[TokenEvent]:
        """One engine tick: admit + prefill, then one decode over the pool.
        Returns the tokens emitted."""
        events: List[TokenEvent] = []
        for slot in self.scheduler.admit():
            self._admit(slot, events)
        active = self.scheduler.active_slots
        if not active:
            return events
        for slot in active:
            self._ensure_decode_block(slot)
        tables = torch.as_tensor(self._tables, device=self.device)
        inputs = torch.as_tensor(self._inputs, dtype=torch.int64, device=self.device)
        logits, self.pool = self.model.decode_step_paged(
            self.params, self.pool, inputs, tables, cache_t=self._cache_t
        )
        for slot in active:
            self._rows[slot.index] += 1
        gens = {s.index: self._generator(s.request) for s in active}
        sampled = sample_token(
            logits[:, -1], [gens.get(i) for i in range(self.cb.num_slots)],
            self.cfg, self.cb.temperature,
        )
        toks = sampled.cpu().numpy()  # the tick's one device -> host transfer
        for slot in active:
            self._record(slot, int(toks[slot.index]), events)
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
        """Bytes one token row costs across all layers (K + V)."""
        k = self.pool["layers"]["k"]
        return 2 * k.shape[0] * k.shape[3] * k.shape[4] * k.element_size()

    def kv_stats(self) -> Dict[str, Any]:
        bs = self.block_pool.block_size
        block_bytes = bs * self.kv_row_bytes()
        return {
            "layout": "paged",
            "kv_dtype": "fp32",
            "used_blocks": self.block_pool.used_blocks,
            "free_blocks": self.block_pool.free_blocks,
            "total_blocks": self.block_pool.usable_blocks,
            "kv_bytes_per_token": float(self.kv_row_bytes()),
            "kv_bytes_in_use": self.block_pool.used_blocks * block_bytes,
            "kv_bytes_capacity": self.block_pool.usable_blocks * block_bytes,
            "peak_used_blocks": self.peak_used_blocks,
            "peak_kv_bytes": self.peak_used_blocks * block_bytes,
            "preemptions": 0,
        }

    def stats(self) -> Dict[str, Any]:
        return {"ticks": self.ticks, "kv": self.kv_stats(),
                "metrics": self.metrics.snapshot()}
