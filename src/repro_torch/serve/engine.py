"""Serving engines (port of the reference's ``repro.serve.engine``):
``sample_token``; the lockstep ``ServeEngine`` (one prefill, then
synchronized decode) for every family: attention models, the ssm, hybrid
(recurrentgemma) and encdec (seamless, with its stub ``src_embeds`` frames)
families; and ``ContinuousBatchingEngine`` for the attention family, over the dense
per-slot KV pool (the default layout) or the paged block pool, with
quantized page pools, the shared-prefix cache and preemption on the paged
layout, chunked prefill and sliding-window ring caches on both.  Dense,
MoE and VLM models serve alike; a MoE prompt's chunks share its whole-prompt
expert capacity, and a MoE arch opts out of the prefix cache, as in the
reference.  A VLM request brings its stub patch embeddings (``submit(...,
patch_embeds=...)``; ``ServeEngine.generate`` takes them for the batch): they
are kept per request until it finishes, so a preempted request re-prefills
with them, go with the monolithic prefill or the first chunk, and count
``num_patches`` rows in every capacity check; such a request never looks up
or inserts into the prefix trie, while a text-only request on the same
engine still shares.

The layout: ``ContinuousConfig.kv_layout`` picks it, and the ``"paged"``
marker impl of ``attention`` — through ``ops.use(attention="paged")`` or the
config's own attention spec — flips the engine to the block pool, as in
the reference.  The dense pool holds ``[L, S, T, Hkv, D]`` with ``T =
cache_len(max_len)``: every slot's row is pinned whatever its length, and
decode runs ``ops.attention`` over it at ``Tq = 1`` (the flash_star kernel
under ``impl="pallas"``), masked by each slot's valid length.

One ``step()`` tick of the continuous engine::

    admit:    pending -> free slot.  Monolithic: (paged: allocate blocks)
              prefill (batch 1), write_slot / write_slot_paged, sample token
              0.  Chunked (a prefix cache or a chunk budget): adopt the
              trie's cached prefix blocks (paged) and queue the rest of the
              prompt for staging
    prefill:  chunked only — this tick's prompt-token budget flows through
              the staging slots in power-of-two chunks (``prefill`` then
              ``prefill_extend`` into a linear staging cache); a finished
              prompt (a ring: folded by ``finalize_ring_cache``) is written
              into the pool (paged: fresh blocks, indexed in the trie) and
              samples token 0
    upkeep:   paged, not a ring: every active slot whose next KV row opens a
              block gets one; on exhaustion cold trie leaves are evicted
              first, then the latest-admitted slot is preempted (requeued at
              the front with its tokens kept)
    decode:   the fused device tick (DESIGN.md §11): (paged: the dirty rows
              of the device-resident ``[S, W]`` block table are flushed) the
              ``[S, 1]`` int32 token inputs go up, and one CUDA graph
              replays decode over all S slots plus sampling; one transfer
              brings the sampled tokens down
    retire:   finished slots' counters go back to 0 (paged: their blocks are
              released and their tables point at the scratch block)

The tick's graph (``serve.graph.StepGraphs``) is keyed by the routes it
resolved (the layout and the pool's rows among them); ``graph_entries()``
counts the captures.  Inside it, greedy decoding takes the ``argmax``; at
temperature > 0 without a guard the sampling softmax runs there too
(``ops.softmax`` over ``logits / T``, the STAR kernel under
``ops.use(softmax="pallas")``), and each active request then draws its
token outside the graph from its own seeded ``torch.Generator`` (``draw``),
so a request's draws depend neither on its co-tenants nor on preemption.
The draws are not the reference's ``jax.random`` draws.  Under a guard the
sampling runs eagerly after the graphed decode, as the reference's guarded
path does.  Prefill and prefill chunks stay eager.  On the CPU the same
tick runs eagerly.

A fault in the config's softmax spec (``FaultModel``) degrades every STAR
softmax of the model, attention rows and sampling alike.  With
``ContinuousConfig.guard`` set, one ``AccuracyGuard`` per engine holds every
sampling softmax to the exact oracle, falls back to the clean ``reference``
backend on a trip, and reports its counters in ``stats()["guard"]``.

Observability (DESIGN.md §10): the reference's tracer spans and instants
under its names (``serve.submit`` / ``admit`` / ``prefill`` /
``prefill_chunk`` / ``decode`` / ``preempt`` / ``finish``, the
``serve.sched`` counter track and, paged, ``kv.blocks``, one async
``request`` track per uid), and its transfer counters: ``serve.bytes.h2d``
and ``serve.bytes.d2h`` (the bytes the engine moves across the host-device
boundary) and, paged only, ``kv.gather.bytes`` (``ops.paged_gather_bytes``,
a traffic model).  The port's own spans, recorded only while the tracer
records:

* inside ``serve.decode``, one span a phase of the tick:
  ``serve.tick.upload`` (dirty table rows and the ``[S, 1]`` inputs),
  ``serve.tick.graph`` (the replay, a capture included),
  ``serve.tick.sample`` (the draws and the tokens' transfer down: the host
  waits for the device here) and ``serve.tick.record`` (the traffic count,
  then ``_record`` over the active slots: ``on_token``, retire, release);
* ``serve.tick.device`` (args ``tick``, ``device_ms``): the replay's device
  time from a pair of CUDA events recorded around it on its stream, read
  after the tokens' transfer, which already waited for them (a capturing
  tick's includes its warm-up);
* ``serve.prefill.device`` (args ``uid``, ``rows``, ``device_ms``): the same
  events around a monolithic admission's prefill and pool write, read after
  its first token's transfer;
* ``serve.queue_wait`` (arg ``uid``): a stint in the pending queue, on the
  engine's clock, ending at the tracer's reading of the admission.

The three last are recorded after the fact (``Tracer.complete``); on the
CPU there are no events and ``device_ms`` is left out.  Every span and
``begin`` / ``end`` pair is also a ``torch.profiler`` range of its name
(the tracer's bridge).  Under the no-op tracer none of this runs: no range,
no event, no clock read.  The engines compute with
``models.param.compute_params``: weights cast to the compute dtype once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.core.kvquant import validate_kv_dtype
from repro_torch.distributed.sharding import current_mesh_rules, is_dtensor
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.param import compute_params, named_leaves, tree_map
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NullTracer, Tracer, get_tracer
from repro_torch.ops import registry
from repro_torch.ops.platform import Device, resolve_device
from repro_torch.serve.graph import StepGraphs
from repro_torch.serve.paged import SCRATCH_BLOCK, BlockPool, PrefixCache, bucket_blocks
from repro_torch.serve.scheduler import Request, Slot, SlotScheduler


def scaled_logits(logits: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    """``logits / T`` in float32, divided by a tensor on the logits' device:
    an IEEE division on the card as on the CPU.  (A Python float divisor
    becomes a multiply by its reciprocal on CUDA, which can move the last
    bit.)"""
    return logits.float() / temperature


def sampling_probs(
    logits: torch.Tensor,  # [..., V]
    temperature: torch.Tensor,  # 0-dim float32 on the logits' device
    cfg: ModelConfig,
    guard: Optional[ops.AccuracyGuard] = None,
    star_sampling: bool = True,
) -> torch.Tensor:
    """The sampling distribution: one softmax over ``logits / T`` with the
    config's softmax spec (the STAR engine unless its kind is exact or
    ``star_sampling`` is off; held to the exact oracle by ``guard`` when
    given)."""
    scaled = scaled_logits(logits, temperature)
    spec = cfg.softmax_spec
    if spec.kind == "exact" or not star_sampling:
        return torch.softmax(scaled, dim=-1)
    return ops.softmax(scaled, spec, guard=guard)


INVALID_TOKEN = -1  # what :func:`draw` gives a row that is not a distribution


def draw(probs: torch.Tensor, generators: Sequence[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of ``probs`` ``[..., V]`` from that
    row's generator: ``argmax(p / q)`` with ``q ~ Exp(1)``, the algorithm
    and generator use of ``torch.multinomial(p, 1)`` without its host-side
    checks (each a device-to-host sync).  Their check runs on the device
    instead: a row that ``torch.multinomial`` refuses (a NaN, an infinity
    or a negative entry, or no entry above zero) draws ``INVALID_TOKEN``,
    which comes down with the tokens and :func:`check_drawn` raises on.
    int32 ``probs.shape[:-1]``."""
    rows = probs.reshape(-1, probs.shape[-1])
    if rows.shape[0] != len(generators):
        raise ValueError(f"{rows.shape[0]} rows but {len(generators)} generators")
    out = torch.stack([
        torch.argmax(r / torch.empty_like(r).exponential_(1.0, generator=g))
        for r, g in zip(rows, generators)])
    valid = ((rows >= 0) & torch.isfinite(rows)).all(-1) & (rows.sum(-1) > 0)
    out = torch.where(valid, out, INVALID_TOKEN)
    return out.to(torch.int32).reshape(probs.shape[:-1])


def check_drawn(tokens: np.ndarray) -> None:
    """Raise where a draw met a row that is not a distribution (its token
    is ``INVALID_TOKEN``), as ``torch.multinomial`` raises on one."""
    bad = np.argwhere(np.asarray(tokens) == INVALID_TOKEN)
    if bad.size:
        raise RuntimeError(
            f"sampling distribution at {bad[:8].tolist()} holds a NaN, an infinity or a "
            "negative probability, or nothing above zero: no token drawn")


def sample_token(
    logits: torch.Tensor,  # [..., V]
    generators: Sequence[torch.Generator],  # one per row of logits
    cfg: ModelConfig,
    temperature: float,
    guard: Optional[ops.AccuracyGuard] = None,
    star_sampling: bool = True,
) -> torch.Tensor:
    """Greedy (``temperature <= 0``: argmax) or temperature sampling:
    :func:`sampling_probs`, then one :func:`draw` per row."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    return draw(sampling_probs(logits, t, cfg, guard, star_sampling), generators)


def prefix_rows(cfg: ModelConfig, frontend: Dict[str, Any]) -> int:
    """KV rows the frontend prepends before the prompt: a VLM's
    ``num_patches`` when the request brings ``patch_embeds``, else 0 (the
    reference's ``ContinuousBatchingEngine._prefix_rows``).  The one
    definition that every capacity check, block count and staging size
    reads, in both engines."""
    if cfg.family == "vlm" and "patch_embeds" in frontend:
        return cfg.num_patches
    return 0


class MeshNotServedError(NotImplementedError):
    """Serving over a device mesh is not ported: decode over a cache sharded
    along its rows needs the partial softmax with one all-reduce, which the
    reference reaches only in its dry-run lowering (ROADMAP.md, the dry-run
    tools).  The engines serve on one device."""


def refuse_mesh_serving(params: Dict[str, Any], engine: str) -> None:
    """Raise :class:`MeshNotServedError` under ``use_mesh_rules`` or for
    parameters that are DTensors on a mesh."""
    if current_mesh_rules() is not None or any(
            is_dtensor(leaf) for _, leaf in named_leaves(params)):
        raise MeshNotServedError(
            f"{engine} serves on one device: serving over a mesh (a row-sharded KV "
            "cache) is not ported; pass whole tensors, outside use_mesh_rules")


@dataclasses.dataclass
class LockstepState:
    """A lockstep ``generate``'s decode state.  The cache and the token
    buffer are the decode graph's static state, updated in place."""
    cache: Dict[str, Any]
    tokens: torch.Tensor  # [B, 1] int32: the last tokens, the graph's input
    generators: List[torch.Generator]  # one per row
    temperature: Optional[torch.Tensor]  # 0-dim float32; None: greedy
    route: Any  # the graph's key


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
    are the parity oracle).  An attention model decodes over a scalar-
    ``len`` cache of ``cache_len(max_len)`` rows (a ring under a sliding
    window, and always for the hybrid's local attention); ``generate``
    refuses a run that would write past a cache that is no ring (a decoder
    LM's, an enc-dec model's self cache), where the reference's
    ``dynamic_update_slice`` silently clamps the write.

    Each ``generate`` (``begin``, then ``decode`` per step) captures its
    decode step once (the counterpart of the reference's
    ``jax.jit(decode_step)``): the prefill's cache and a ``[B, 1]`` token
    buffer are the graph's static state (:class:`LockstepState`), updated in
    place by every replay; greedy decoding takes the ``argmax`` inside the
    graph, sampling its softmax, and the draws run outside it.  ``graphs``
    is the last ``begin``'s :class:`StepGraphs`."""

    def __init__(self, model_cfg: ModelConfig, params: Dict[str, Any],
                 serve_cfg: ServeConfig = ServeConfig(), *, device: Device = None,
                 seed: int = 0):
        refuse_mesh_serving(params, "ServeEngine")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on {self.device}")
        self.cfg = model_cfg
        self.serve_cfg = serve_cfg
        self.model = build_model(model_cfg)
        self.params = compute_params(params, model_cfg)
        self.seed = seed
        self.graphs: Optional[StepGraphs] = None

    def _step(self, cache, tokens, temperature):
        """One decode step over the batch, then greedy tokens ``[B]`` or the
        sampling distribution ``[B, V]``."""
        logits, _ = self.model.decode_step(self.params, cache, tokens)
        last = logits[:, -1]
        if temperature is None:
            return torch.argmax(last, dim=-1).to(torch.int32)
        return sampling_probs(last, temperature, self.cfg,
                              star_sampling=self.serve_cfg.star_sampling)

    @torch.no_grad()
    def begin(self, prompts, **frontend) -> LockstepState:
        """Prefill ``prompts`` ``[B, T]`` (a VLM: with ``patch_embeds`` ``[B,
        P, frontend_dim]``, the stub patch prefix; an enc-dec model: with
        ``src_embeds`` ``[B, T_src, frontend_dim]``, the stub frames) and
        sample each row's first token (left in ``state.tokens``); ``graphs``
        starts anew."""
        prompts = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
        sc = self.serve_cfg
        gens = [torch.Generator(device=self.device).manual_seed(self.seed + i)
                for i in range(prompts.shape[0])]
        greedy = sc.temperature <= 0.0
        temperature = None if greedy else torch.full(
            (), sc.temperature, dtype=torch.float32, device=self.device)
        self.graphs = StepGraphs(self.device)
        logits, cache = self.model.prefill(self.params, prompts, sc.max_len, **frontend)
        tok = sample_token(logits[:, -1], gens, self.cfg, sc.temperature,
                           star_sampling=sc.star_sampling)
        route = ("lockstep decode", tuple(prompts.shape), "greedy" if greedy else "sampled",
                 self.cfg.softmax_spec.impl, self.cfg.attention_spec.impl)
        return LockstepState(cache, tok[:, None].clone(), gens, temperature, route)

    @torch.no_grad()
    def decode(self, state: LockstepState) -> torch.Tensor:
        """One decode step by replay of the step's graph (captured at the
        first call after ``begin``), the draws outside it: the next tokens
        ``[B]`` int32, also written into ``state.tokens``."""
        cache, tokens, temperature = state.cache, state.tokens, state.temperature
        out = self.graphs.run(
            state.route, lambda: self._step(cache, tokens, temperature),
            lambda: self._step(tree_map(torch.clone, cache), tokens.clone(), temperature))
        tok = out.clone() if temperature is None else draw(out, state.generators)
        tokens.copy_(tok[:, None])
        return tok

    def generate(self, prompts, num_tokens: int, **frontend):
        """prompts ``[B, T]`` -> (generated ``[B, num_tokens]`` int32,
        ``{"cache_len": ...}``): ``begin``, then ``num_tokens - 1`` steps of
        ``decode``; the tokens are checked once, at the end.  ``frontend``:
        a VLM's ``patch_embeds`` or an enc-dec model's ``src_embeds`` stubs.
        An attention model without a ring (an enc-dec model's self cache
        among them) needs ``P + T + num_tokens - 1`` cache rows (``P`` the
        patch rows): more raises a ValueError before the prefill."""
        if isinstance(self.model, (DecoderLM, EncDecLM)):
            prefix = prefix_rows(self.cfg, frontend)
            rows = prefix + np.shape(prompts)[1] + num_tokens - 1
            cache_t = self.model.cache_len(self.serve_cfg.max_len)
            if self.cfg.sliding_window is None and rows > cache_t:
                raise ValueError(
                    f"generate needs {rows} cache rows (prompt {np.shape(prompts)[1]} + "
                    f"prefix {prefix} + {num_tokens} new tokens - 1) but the cache holds "
                    f"{cache_t} (max_len={self.serve_cfg.max_len}); pass a larger max_len")
        state = self.begin(prompts, **frontend)
        outs = [state.tokens[:, 0].clone()]
        for _ in range(num_tokens - 1):
            outs.append(self.decode(state))
        out = torch.stack(outs, dim=1)
        check_drawn(out.cpu().numpy())
        return out, {"cache_len": int(state.cache["len"])}


@dataclasses.dataclass
class ContinuousConfig:
    num_slots: int = 8
    max_len: int = 512  # per-slot capacity (prompt + generation)
    temperature: float = 0.0  # 0 = greedy
    # KV layout: "dense" per-slot rows of cache_len(max_len), or "paged"
    # blocks behind per-request tables; ops.use(attention="paged") or a
    # config whose attention impl is "paged" flips it to "paged"
    kv_layout: str = "dense"
    kv_block_size: int = 16
    # usable blocks (scratch excluded); None = num_slots * ceil(cache_len / bs)
    kv_pool_blocks: Optional[int] = None
    # shared-prefix KV cache: a radix trie over block-size token chunks
    # (paged layout only; rings and MoE archs opt out)
    prefix_cache: bool = False
    # chunked prefill: prompt tokens prefilled per tick (None: monolithic)
    prefill_chunk_tokens: Optional[int] = None
    # page-pool storage: fp32 (compute dtype) | int8 | fp8_e4m3 (quantized:
    # paged layout only)
    kv_dtype: str = "fp32"
    # accuracy guard on the sampling softmax: sampled comparison against the
    # exact oracle, fallback to a clean backend; counters in stats()["guard"]
    guard: Optional[ops.GuardConfig] = None
    star_sampling: bool = True  # STAR softmax on the output distribution

    def as_serve_config(self) -> ServeConfig:
        """The lockstep engine's sampling settings of this config."""
        return ServeConfig(self.max_len, self.temperature, self.star_sampling)


@dataclasses.dataclass
class TokenEvent:
    uid: int
    token: int
    index: int  # 0-based position within the request's generation
    finished: bool


class ContinuousBatchingEngine:
    """Slot-pool serving over a dense or paged KV cache on ``device`` (the
    card unless ``device="cpu"``); ``params`` must live there.  ``on_token``
    is called with every emitted :class:`TokenEvent` (streaming).  ``tracer``
    defaults to the global one at construction (``obs.get_tracer()``: the
    no-op tracer unless ``obs.enable_tracing()`` ran first); ``metrics``
    defaults to a registry of the engine's own, and ``clock`` (the request
    lifecycle's timestamps) to ``time.perf_counter``."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        params: Dict[str, Any],
        cb_cfg: ContinuousConfig = ContinuousConfig(),
        *,
        device: Device = None,
        seed: int = 0,
        on_token: Optional[Callable[[TokenEvent], None]] = None,
        tracer: Optional[Tracer | NullTracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        refuse_mesh_serving(params, "ContinuousBatchingEngine")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on {self.device}")
        validate_kv_dtype(cb_cfg.kv_dtype)
        if cb_cfg.prefill_chunk_tokens is not None and cb_cfg.prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got {cb_cfg.prefill_chunk_tokens}")
        self.cfg = model_cfg
        self.cb = cb_cfg
        self.model = build_model(model_cfg)
        if not isinstance(self.model, DecoderLM):
            raise ValueError(
                "continuous batching needs the per-slot KV-cache pool, which only "
                f"attention-family models implement (got {model_cfg.family!r})")
        self.params = compute_params(params, model_cfg)
        self.tracer = tracer if tracer is not None else get_tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._clock = clock if clock is not None else time.perf_counter
        self._on_token = on_token
        reg = self.metrics
        self._m_submitted = reg.counter("serve.requests.submitted")
        self._m_admitted = reg.counter(
            "serve.requests.admitted", "admissions incl. re-admissions")
        self._m_tokens = reg.counter("serve.tokens.generated")
        self._m_finished = reg.counter("serve.requests.finished")
        self._m_prefills = reg.counter(
            "serve.prefill.calls", "model prefill / prefill_extend calls (one per chunk)")
        self._m_preempted = reg.counter(
            "serve.requests.preempted", "requests evicted on pool exhaustion and requeued")
        self._h_ttft = reg.histogram("serve.ttft_s", "submit -> first token")
        self._h_itl = reg.histogram("serve.itl_s", "inter-token latency")
        self._h_queue = reg.histogram("serve.queue_wait_s", "pending-queue wait per stint")
        self._g_queue = reg.gauge("serve.queue.depth")
        self._g_active = reg.gauge("serve.slots.active")
        self._m_h2d = reg.counter(
            "serve.bytes.h2d", "host->device bytes: prompt tokens, a VLM request's patch "
            "embeddings (once, at submit), admission write tables, dirty table rows, the "
            "[S, 1] int32 token inputs")
        self._m_d2h = reg.counter(
            "serve.bytes.d2h", "device->host bytes: the sampled tokens (one per admission, "
            "one vector per tick), the guard's error per check")
        self._m_gather = reg.counter(
            "kv.gather.bytes", "counted K+V bytes decode reads from the page pool "
            "(ops.paged_gather_bytes traffic model)")
        self._m_rows_flushed = reg.counter(
            "serve.tables.rows_flushed", "dirty block-table rows uploaded before a tick")
        self._g_graphs = reg.gauge(
            "serve.graph.entries", "captured CUDA graphs of the decode tick")
        self.scheduler = SlotScheduler(cb_cfg.num_slots)
        # the layout: the config picks it; the "paged" marker impl of
        # attention (an ops.use frame or the config's spec) flips it
        layout = cb_cfg.kv_layout
        forced = registry.active_overrides("attention").get("impl")
        if "paged" in (forced, model_cfg.attention_spec.impl):
            layout = "paged"
        if layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got {layout!r}")
        self.kv_layout = layout
        self._paged = layout == "paged"
        self._cache_t = self.model.cache_len(cb_cfg.max_len)
        # a ring (sliding window no longer than max_len) wraps in place: its
        # blocks are allocated once per admission, never appended
        self._ring = (model_cfg.sliding_window is not None
                      and self._cache_t <= model_cfg.sliding_window)
        s_count = cb_cfg.num_slots
        self.block_pool: Optional[BlockPool] = None
        self.prefix: Optional[PrefixCache] = None
        self._tables_dev: Optional[torch.Tensor] = None
        if self._paged:
            bs = cb_cfg.kv_block_size
            self._slot_blocks = -(-self._cache_t // bs)  # table width W
            usable = cb_cfg.kv_pool_blocks
            if usable is None:
                usable = cb_cfg.num_slots * self._slot_blocks
            self.block_pool = BlockPool(usable + 1, bs, kv_dtype=cb_cfg.kv_dtype,
                                        metrics=self.metrics)
            if self._ring and self._slot_blocks > self.block_pool.usable_blocks:
                raise ValueError(
                    f"a sliding-window ring needs {self._slot_blocks} blocks per slot but "
                    f"the pool only has {self.block_pool.usable_blocks}; raise kv_pool_blocks")
            self.pool = self.model.init_paged_cache(usable + 1, bs, cb_cfg.num_slots,
                                                    device=self.device,
                                                    kv_dtype=cb_cfg.kv_dtype)
            self._tables = np.full((s_count, self._slot_blocks), SCRATCH_BLOCK, np.int32)
            # the device-resident mirror the tick reads: allocator edits mark
            # their slot dirty and only dirty rows go up (steady decode: none)
            self._tables_dev = torch.full((s_count, self._slot_blocks), SCRATCH_BLOCK,
                                          dtype=torch.int32, device=self.device)
            # rings opt out of sharing: a wrapped window no longer holds the
            # prefix rows a later request would adopt; MoE archs opt out as
            # the reference's do (the requests still take the chunked path)
            if cb_cfg.prefix_cache and not self._ring and model_cfg.family != "moe":
                self.prefix = PrefixCache(self.block_pool, metrics=self.metrics)
        else:
            if cb_cfg.kv_dtype != "fp32":
                raise ValueError(
                    f"kv_dtype={cb_cfg.kv_dtype!r} requires kv_layout='paged' (scales are "
                    "per-block; the dense per-slot pool has no blocks) — pass "
                    "kv_layout='paged' or drop kv_dtype")
            if cb_cfg.prefix_cache:
                raise ValueError(
                    "prefix_cache requires kv_layout='paged' (the dense pool has no "
                    "shareable blocks); pass kv_layout='paged' or drop the flag")
            self._slot_blocks = 0
            self.pool = self.model.init_pool_cache(s_count, cb_cfg.max_len, device=self.device)
        # either flag routes admission through the staging path
        self._chunked = cb_cfg.prefill_chunk_tokens is not None or cb_cfg.prefix_cache
        self._staging: Dict[int, Dict[str, Any]] = {}
        self._dirty: set = set()
        self._rows = np.zeros(s_count, np.int64)  # KV rows written per slot
        self._inputs = np.zeros((s_count, 1), np.int32)  # next token per slot
        self._inputs_dev = torch.zeros((s_count, 1), dtype=torch.int32, device=self.device)
        self._seed = seed
        self._generators: Dict[int, torch.Generator] = {}
        # per-request frontend inputs (a VLM's patch embeddings, on the
        # device), kept until the request finishes: a preempted request
        # re-prefills with them
        self._frontend: Dict[int, Dict[str, torch.Tensor]] = {}
        # one guard for the engine's lifetime: counters accumulate and the
        # trip latch persists across ticks
        self.guard = ops.AccuracyGuard(cb_cfg.guard) if cb_cfg.guard is not None else None
        # the tick's sampling: greedy and temperature sampling run in the
        # graph; the guard compares on the host, so under it the sampling
        # softmax runs eagerly after the graph (as the reference's guard path)
        self._greedy = cb_cfg.temperature <= 0.0
        self._eager_sampling = (not self._greedy and self.guard is not None
                                and cb_cfg.star_sampling
                                and model_cfg.softmax_spec.kind != "exact")
        self._temperature = None if self._greedy else torch.full(
            (), cb_cfg.temperature, dtype=torch.float32, device=self.device)
        sampling = ("greedy" if self._greedy else
                    "eager sampling" if self._eager_sampling else "sampled")
        self._route = ("tick", s_count, self._slot_blocks, cb_cfg.kv_dtype, sampling,
                       model_cfg.paged_attention_spec.impl, model_cfg.softmax_spec.impl,
                       layout, self._cache_t, model_cfg.attention_spec.impl)
        self.graphs = StepGraphs(self.device)
        # the device-timed regions' pair of CUDA events (the tick's replay, a
        # monolithic admission), made once and only while the tracer records
        self._timing = None
        if self.tracer.enabled and self.device.type == "cuda":
            self._timing = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self.ticks = 0
        self.preemptions = 0
        self.peak_used_blocks = 0

    def graph_entries(self) -> int:
        """Captured graphs of the tick (the reference's
        ``jit_cache_entries``): one per route a tick resolved."""
        return self.graphs.entries()

    # -- submission -------------------------------------------------------------

    def submit(self, prompt: Sequence[int] | np.ndarray, max_new_tokens: int, *,
               eos_id: Optional[int] = None, arrival_time: float = 0.0,
               **frontend) -> int:
        """Queue a request (never blocks); returns its uid.  The request ends
        after ``max_new_tokens`` tokens or on ``eos_id``, which it emits
        (``finished=True``); ``arrival_time`` is kept on the request and never
        read by admission.  ``frontend``: a VLM's ``patch_embeds``
        ``[1, P, frontend_dim]``, prepended as ``P`` KV rows (such a request
        never shares through the prefix trie)."""
        prefix = prefix_rows(self.cfg, frontend)
        need = prefix + len(prompt) + max_new_tokens - 1
        # decode writes prompt + (max_new_tokens - 1) rows; a ring wraps
        if self.cfg.sliding_window is None and need > self.cb.max_len:
            raise ValueError(
                f"request needs {need} cache rows (prompt {len(prompt)} + prefix "
                f"{prefix} + {max_new_tokens} new tokens) but the pool was built with "
                f"max_len={self.cb.max_len}"
            )
        if self._paged:
            bp = self.block_pool
            blocks = self._slot_blocks if self._ring else bp.blocks_for_tokens(need)
            if blocks > bp.usable_blocks:
                # larger than the whole pool: no preemption could ever fit it
                raise ValueError(f"request needs {blocks} KV blocks but the pool only has "
                                 f"{bp.usable_blocks}; raise kv_pool_blocks")
        uid = self.scheduler.submit(prompt, max_new_tokens, eos_id=eos_id,
                                    arrival_time=arrival_time)
        if frontend:
            fe = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                  for k, v in frontend.items()}
            self._m_h2d.inc(sum(t.numel() * 4 for t in fe.values()))
            self._frontend[uid] = fe
        req = self.scheduler.pending[-1]
        req.submit_time = req.enqueued_at = self._clock()
        self._m_submitted.inc()
        self._g_queue.set(len(self.scheduler.pending))
        if self.tracer.enabled:
            self.tracer.instant("serve.submit", uid=uid, prompt_len=len(prompt),
                                max_new_tokens=max_new_tokens)
            self.tracer.async_begin("request", uid)
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
        now = self._clock()
        if req.first_token_time is None:
            self._h_ttft.observe(now - req.submit_time)
            req.first_token_time = now
        else:
            self._h_itl.observe(now - req.last_token_time)
        req.last_token_time = now
        self._m_tokens.inc()
        if self._on_token is not None:
            self._on_token(ev)
        return ev

    def _record(self, slot: Slot, tok: int, events: List[TokenEvent]) -> None:
        finished = self.scheduler.record_token(slot, tok)
        events.append(self._emit(slot, tok, finished))
        self._inputs[slot.index, 0] = tok
        if finished:
            self._finish(slot)

    def _sample_first(self, slot: Slot, logits: torch.Tensor, events: List[TokenEvent]) -> None:
        checks = self.guard.checks if self.guard is not None else 0
        tok = sample_token(logits[0, -1], [self._generator(slot.request)], self.cfg,
                           self.cb.temperature, guard=self.guard,
                           star_sampling=self.cb.star_sampling)
        host = tok.cpu().numpy()  # one token down
        self._m_d2h.inc(4 + 4 * self._guard_checks_since(checks))
        check_drawn(host)
        self._record(slot, int(host), events)

    def _guard_checks_since(self, checks: int) -> int:
        """Oracle checks the guard ran since it counted ``checks``: each
        brings its error down as one float32."""
        return self.guard.checks - checks if self.guard is not None else 0

    def _observe_queue_wait(self, req: Request) -> None:
        # consume the stamp: a later preemption opens a new stint
        if req.enqueued_at is not None:
            wait = self._clock() - req.enqueued_at
            self._h_queue.observe(wait)
            if self.tracer.enabled:
                end = self.tracer.now()
                self.tracer.complete("serve.queue_wait", end - wait, end, uid=req.uid)
            req.enqueued_at = None

    def _device_begin(self) -> float:
        """Open a device-timed region (tracing only): the tracer's reading,
        then, on the card, the start event on the current stream."""
        t0 = self.tracer.now()
        if self._timing is not None:
            self._timing[0].record()
        return t0

    def _device_end(self) -> None:
        if self._timing is not None:
            self._timing[1].record()

    def _device_span(self, name: str, t0: float, **args: Any) -> None:
        """The complete span ``name`` from ``t0`` to now, with the region's
        device time in ms (on the card).  Called after a transfer that
        waited for the end event: reading it adds no synchronisation."""
        if self._timing is not None:
            args["device_ms"] = self._timing[0].elapsed_time(self._timing[1])
        self.tracer.complete(name, t0, self.tracer.now(), **args)

    def _set_table(self, idx: int, blocks: Sequence[int] = ()) -> None:
        """The slot's host table row: ``blocks`` then scratch; marks it dirty."""
        self._tables[idx, :] = SCRATCH_BLOCK
        self._tables[idx, :len(blocks)] = blocks
        self._dirty.add(idx)

    def _clear_slot(self, slot: Slot) -> None:
        if self._paged:
            self._set_table(slot.index)
        self.model.reset_slot(self.pool, slot.index)

    def _finish(self, slot: Slot) -> None:
        req = self.scheduler.retire(slot)
        self._generators.pop(req.uid, None)
        self._frontend.pop(req.uid, None)
        if self._paged:
            self.block_pool.release(req.uid)
        self._clear_slot(slot)
        self._m_finished.inc()
        if self.tracer.enabled:
            self.tracer.instant("serve.finish", uid=req.uid,
                                tokens=len(self.scheduler.finished[req.uid]))
            self.tracer.async_end("request", req.uid)

    def _note_peak(self) -> None:
        self.peak_used_blocks = max(self.peak_used_blocks, self.block_pool.used_blocks)

    def _tokens(self, req: Request) -> np.ndarray:
        """What a (re-)admission prefills: the prompt plus any tokens the
        request generated before a preemption."""
        if req.generated_prefix:
            return np.concatenate([req.prompt, np.asarray(req.generated_prefix, np.int32)])
        return np.asarray(req.prompt, np.int32)

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """An int32 host array on the device, counted in ``serve.bytes.h2d``."""
        self._m_h2d.inc(host.size * 4)
        return torch.as_tensor(np.asarray(host, np.int32), device=self.device)

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
            req.enqueued_at = self._clock()
        self.tracer.instant("serve.preempt", uid=req.uid,
                            generated=len(req.generated_prefix))

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
        n = self._slot_blocks if self._ring else self.block_pool.blocks_for_tokens(rows)
        if not self._reclaim_blocks(n, req.uid):
            self.scheduler.pending.appendleft(slot.release())
            return False
        self._set_table(slot.index, self.block_pool.allocate(req.uid, n))
        self._note_peak()
        return True

    def _ensure_decode_block(self, slot: Slot) -> bool:
        """Grow the slot's table when this tick's KV write opens a block;
        preempt on exhaustion (the slot itself when it is the
        lowest-priority occupant).  False if the slot was evicted.  A ring
        holds its blocks from admission on."""
        if self._ring:
            return True
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
        self._dirty.add(slot.index)
        self._note_peak()
        return True

    # -- monolithic admission -----------------------------------------------------

    def _admit(self, slot: Slot, events: List[TokenEvent]) -> None:
        """(Paged: allocate the slot's blocks.)  Prefill its prompt, write
        the KV rows into the pool and sample the next token."""
        req = slot.request
        tokens = self._tokens(req)
        fe = self._frontend.get(req.uid, {})
        rows = prefix_rows(self.cfg, fe) + len(tokens)
        prefill_len = self.cb.max_len
        if self._paged:
            if not self._admit_blocks(slot, rows):
                return  # pool full even after preemption: wait in line
            # the prefill cache spans the bucketed block grid; grid rows past
            # the allocated blocks land in the scratch block (a ring keeps its
            # whole window: it wraps in place)
            width = self._slot_blocks if self._ring else bucket_blocks(
                self.block_pool.blocks_for_tokens(rows), self._slot_blocks)
            if not self._ring:
                prefill_len = width * self.block_pool.block_size
        self._observe_queue_wait(req)
        self._m_admitted.inc()
        traced = self.tracer.enabled
        if traced:
            self.tracer.instant("serve.admit", uid=req.uid, slot=slot.index, rows=rows)
        with self.tracer.span("serve.prefill", uid=req.uid, rows=rows):
            if traced:
                t0 = self._device_begin()
            logits, cache1 = self.model.prefill(self.params, self._upload(tokens)[None],
                                                prefill_len, **fe)
            self._m_prefills.inc()
            if self._paged:
                table = self._upload(self._tables[slot.index, :width])
                self.model.write_slot_paged(self.pool, cache1, slot.index, table)
            else:
                self.model.write_slot(self.pool, cache1, slot.index)
            if traced:
                self._device_end()
        self._rows[slot.index] = rows
        self._sample_first(slot, logits, events)
        if traced:
            self._device_span("serve.prefill.device", t0, uid=req.uid, rows=rows)

    # -- chunked prefill and the prefix cache -------------------------------------

    def _staging_rows(self, rows: int) -> int:
        """Linear staging-cache capacity.  A ring stages past its window (the
        power of two >= max(rows, window + 1)), so chunks append linearly
        before ``finalize_ring_cache`` folds the buffer; the paged layout
        stages the bucketed admission block grid (the widths of the
        monolithic write); the dense layout the pool row itself."""
        if self._ring:
            return 1 << (max(rows, self.cfg.sliding_window + 1) - 1).bit_length()
        if self._paged:
            nb = bucket_blocks(self.block_pool.blocks_for_tokens(rows), self._slot_blocks)
            return nb * self.block_pool.block_size
        return self._cache_t

    def _admit_staging(self, slot: Slot) -> None:
        """Bind an admitted request to the chunked path: adopt any cached
        prefix blocks (their prefill is skipped) and queue the rest of the
        prompt for ``_run_prefill_chunks``."""
        req = slot.request
        tokens = self._tokens(req)
        fe = self._frontend.get(req.uid, {})
        rows = prefix_rows(self.cfg, fe) + len(tokens)
        p0, shared = 0, []
        if self.prefix is not None and not fe:
            # a frontend prefix (VLM patches) shifts the rows past the token
            # grid: such a request never looks up or inserts
            shared, p0 = self.prefix.lookup(tokens)
            if shared:
                self.block_pool.adopt(req.uid, shared)
        self._staging[slot.index] = {
            "req": req, "fe": fe, "tokens": tokens, "rows": rows, "p0": p0,
            "shared": list(shared), "suffix": tokens[p0:], "done": 0,
            "cache": None, "logits": None, "Ts": self._staging_rows(rows),
            # a MoE prompt's expert capacity, the same in every chunk
            "moe_cap": self.model.moe_prefill_capacity(rows),
        }
        slot.prefilling = True
        self._observe_queue_wait(req)
        self._m_admitted.inc()
        if self.tracer.enabled:
            self.tracer.instant("serve.admit", uid=req.uid, slot=slot.index,
                                rows=rows, prefix_rows=p0)

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
                with self.tracer.span("serve.prefill_chunk", uid=st["req"].uid, tokens=c,
                                      done=st["done"] + c, total=len(suffix)):
                    chunk = self._upload(suffix[st["done"]:st["done"] + c])[None]
                    if st["cache"] is None and st["p0"]:
                        # seed the staging buffer with the cached prefix rows
                        st["cache"] = self.model.gather_prefix_cache(
                            self.pool, st["shared"], st["p0"], st["Ts"])
                    if st["cache"] is None:
                        # the frontend goes with the first chunk only
                        st["logits"], st["cache"] = self.model.prefill(
                            self.params, chunk, self.cb.max_len, cache_t=st["Ts"],
                            moe_capacity=st["moe_cap"], **st["fe"])
                    else:
                        st["logits"], st["cache"] = self.model.prefill_extend(
                            self.params, st["cache"], chunk, moe_capacity=st["moe_cap"])
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
        cache = st["cache"]
        if self._ring:
            cache = self.model.finalize_ring_cache(cache, self._cache_t)
        elif "moe" in cache["layers"]:
            cache = self._strip_staging_cache(cache)
        if not self._paged:
            self.model.write_slot(self.pool, cache, idx)
        else:
            bp = self.block_pool
            if self._ring:
                n_real = n_fresh = self._slot_blocks  # rings never adopt
            else:
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
            self._set_table(idx, table_row)
            self._note_peak()
            if self._ring:
                write_table = table_row
            else:
                # the adopted prefix rows already live in the pool: their
                # write goes to scratch so shared blocks stay untouched; pad
                # to the bucketed grid
                width = st["Ts"] // bp.block_size
                write_table = ([SCRATCH_BLOCK] * len(st["shared"]) + fresh
                               + [SCRATCH_BLOCK] * (width - n_real))
            self.model.write_slot_paged(self.pool, cache, idx,
                                        self._upload(np.asarray(write_table, np.int32)))
            if self.prefix is not None and not st["fe"]:
                self.prefix.insert(st["tokens"], table_row)
        self._rows[idx] = rows
        slot.prefilling = False
        self._sample_first(slot, st["logits"], events)

    @staticmethod
    def _strip_staging_cache(cache: Dict[str, Any]) -> Dict[str, Any]:
        """Drop the staging cache's MoE expert counts before the pool write:
        decode is stateless, as after a monolithic prefill."""
        return {"layers": {"k": cache["layers"]["k"], "v": cache["layers"]["v"]},
                "len": cache["len"], "pos": cache["pos"]}

    def _requeue_staging(self, slot: Slot, st: Dict[str, Any]) -> None:
        req = st["req"]
        if req.uid in self.block_pool.owners():
            self.block_pool.release(req.uid)  # return adopted prefix blocks
        req.enqueued_at = self._clock()  # admission observed: new stint
        self.scheduler.pending.appendleft(slot.release())
        self._clear_slot(slot)

    # -- the tick -----------------------------------------------------------------

    def _tick_body(self, pool, inputs, tables=None):
        """Decode over the whole pool (paged: through ``tables``), then the
        tick's sampling: greedy tokens ``[S]`` int32, or the sampling
        distribution ``[S, V]``, or (eager sampling) nothing; and the
        last-position logits ``[S, V]``."""
        if self._paged:
            logits, _ = self.model.decode_step_paged(self.params, pool, inputs, tables,
                                                     cache_t=self._cache_t)
        else:
            logits, _ = self.model.decode_step(self.params, pool, inputs)
        last = logits[:, -1]
        if self._greedy:
            return torch.argmax(last, dim=-1).to(torch.int32), last
        if self._eager_sampling:
            return None, last
        return sampling_probs(last, self._temperature, self.cfg,
                              star_sampling=self.cb.star_sampling), last

    def _upload_tick_inputs(self) -> None:
        """The tick's only uploads: the dirty table rows (paged; none in
        steady decode) and the ``[S, 1]`` int32 token inputs, into the
        graph's static tensors."""
        for i in sorted(self._dirty):
            self._tables_dev[i].copy_(torch.from_numpy(self._tables[i]))
            self._m_h2d.inc(self._slot_blocks * 4)
            self._m_rows_flushed.inc()
        self._dirty.clear()
        self._inputs_dev.copy_(torch.from_numpy(self._inputs))
        self._m_h2d.inc(self._inputs.size * 4)

    def _tick_state(self):
        """The tick's static state: the pool, the token inputs and (paged)
        the device block table."""
        return self.pool, self._inputs_dev, self._tables_dev

    def _decode(self):
        """Replay the tick's graph (captured at the first tick of a route,
        after an eager warm-up on copies of the pool and inputs)."""
        return self.graphs.run(
            self._route,
            lambda: self._tick_body(*self._tick_state()),
            lambda: self._tick_body(*(None if t is None else tree_map(torch.clone, t)
                                      for t in self._tick_state())))

    def _sample_tick(self, out, active: List[Slot]) -> Dict[int, int]:
        """The active slots' tokens from the tick's outputs: one transfer
        down (greedy: the ``[S]`` vector; sampled: the active rows' draws)."""
        sampled, last = out
        if self._greedy:
            host = sampled.cpu().numpy()
            self._m_d2h.inc(host.size * 4)
            return {s.index: int(host[s.index]) for s in active}
        gens = [self._generator(s.request) for s in active]
        checks = self.guard.checks if self.guard is not None else 0
        if self._eager_sampling:
            # one batched guarded softmax over the active rows (one check)
            rows = torch.stack([last[s.index] for s in active])
            drawn = sample_token(rows, gens, self.cfg, self.cb.temperature, guard=self.guard,
                                 star_sampling=self.cb.star_sampling)
        else:
            drawn = draw(torch.stack([sampled[s.index] for s in active]), gens)
        host = drawn.cpu().numpy()
        self._m_d2h.inc(host.size * 4 + 4 * self._guard_checks_since(checks))
        check_drawn(host)
        return {s.index: int(t) for s, t in zip(active, host)}

    def _count_gather(self) -> None:
        layers = self.pool["layers"]
        pk = layers["k"]
        impl = (registry.active_overrides("paged_attention").get("impl")
                or self.cfg.paged_attention_spec.impl)
        self._m_gather.inc(pk.shape[0] * ops.paged_gather_bytes(
            impl, table_width=self._slot_blocks, block_size=self.block_pool.block_size,
            live_lens=np.minimum(self._rows, self._cache_t), num_kv_heads=pk.shape[3],
            head_dim=pk.shape[4], dtype_bytes=pk.element_size(),
            # the K+V scale rows a quantized read touches per block
            scale_bytes_per_block=8 * pk.shape[3] if "k_scale" in layers else 0))

    def step(self) -> List[TokenEvent]:
        """One engine tick: admissions, prefill chunks, block upkeep, then
        the fused decode tick over the pool.  Returns the tokens emitted."""
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
        if self._paged:
            for slot in sorted(self.scheduler.active_slots, key=lambda s: s.request.uid):
                if not slot.free:
                    self._ensure_decode_block(slot)
        active = self.scheduler.active_slots
        if active:
            traced = self.tracer.enabled
            if traced:
                self.tracer.begin("serve.decode", tick=self.ticks,
                                  uids=[s.request.uid for s in active])
            with self.tracer.span("serve.tick.upload"):
                self._upload_tick_inputs()
            with self.tracer.span("serve.tick.graph"):
                if traced:
                    t0 = self._device_begin()
                out = self._decode()
                if traced:
                    self._device_end()
            for slot in active:
                self._rows[slot.index] += 1
            with self.tracer.span("serve.tick.sample"):
                toks = self._sample_tick(out, active)
            if traced:
                self._device_span("serve.tick.device", t0, tick=self.ticks)
            with self.tracer.span("serve.tick.record"):
                if self._paged:
                    self._count_gather()
                for slot in active:
                    self._record(slot, toks[slot.index], events)
            if traced:
                self.tracer.end("serve.decode")
            self.ticks += 1
        self._g_queue.set(len(self.scheduler.pending))
        self._g_active.set(len(self.scheduler.active_slots))
        self._g_graphs.set(self.graph_entries())
        if self.tracer.enabled:
            self.tracer.counter("serve.sched", pending=len(self.scheduler.pending),
                                active=len(self.scheduler.active_slots))
            if self._paged:
                self.tracer.counter("kv.blocks", used=self.block_pool.used_blocks)
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

    def serve(self, prompts, max_new_tokens, *, eos_id: Optional[int] = None
              ) -> List[List[int]]:
        """Submit all prompts (each stopping at ``eos_id``, if given), drain,
        return the outputs in order."""
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        uids = [self.submit(p, int(m), eos_id=eos_id) for p, m in zip(prompts, max_new_tokens)]
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
        """KV memory accounting, the reference's keys: ``kv_bytes_in_use`` is
        what the pool pins now — the dense layout its whole ``S x T`` rows
        whatever the occupancy, the paged layout its allocated blocks (and,
        paged, the counted decode traffic)."""
        if not self._paged:
            pinned = self.cb.num_slots * self._cache_t * self.kv_row_bytes()
            return {"layout": "dense", "kv_dtype": "fp32",
                    "kv_bytes_per_token": float(self.kv_row_bytes()),
                    "kv_bytes_in_use": pinned, "kv_bytes_capacity": pinned,
                    "peak_kv_bytes": pinned}
        bp = self.block_pool
        bs = bp.block_size
        prefix = None
        if self.cb.prefix_cache:  # a ring or a MoE arch opts out: its counters stay 0
            p = self.prefix
            prefix = {"hits": p.hits if p else 0, "tokens_saved": p.tokens_saved if p else 0,
                      "evicted": p.evicted if p else 0, "nodes": len(p) if p else 0}
        # a block's footprint: its token rows plus its scale rows
        block_bytes = bs * self.kv_row_bytes() + self.kv_scale_bytes_per_block()
        gather = self._m_gather.value()
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
            # counted decode traffic (ops.paged_gather_bytes)
            "gather_bytes": gather,
            "gather_bytes_per_token": gather / max(self._m_tokens.value(), 1.0),
        }

    def stats(self) -> Dict[str, Any]:
        """Ticks, KV accounting, the accuracy guard's counters (calls /
        checks / trips / fallbacks / tripped / last_error; None without a
        guard), the tick's graphs (entries, replays, warm-up launches) and
        the engine's metrics snapshot."""
        return {"ticks": self.ticks, "kv": self.kv_stats(),
                "guard": self.guard.stats() if self.guard is not None else None,
                "graphs": {"entries": self.graphs.entries(), "replays": self.graphs.replays,
                           "capture_seconds": self.graphs.capture_seconds,
                           "warmup_launches": self.graphs.warmup_launches()},
                "metrics": self.metrics.snapshot()}
