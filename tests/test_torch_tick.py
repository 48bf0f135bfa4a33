"""The fused decode tick (DESIGN.md §10–§11) against the JAX reference engine:
weights cast to the compute dtype once, the transfer counters and the
Chrome trace of the same workload, steady decode's uploads,
``ops.paged_gather_bytes``, the graph helper through a stand-in capture
object, the in-place decode steps and the sampling division.

The ``cuda`` tests hold the replayed graph to the eager tick on the card
(bit-equal logits at small widths over fp32 / int8 / fp8 pools), the
launch counts under replay, the lockstep Mamba2 graph, and the card's
``logits / T`` to the CPU's bit for bit; they skip where there is none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs, ops
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _cuda, launch_counts, reset_launch_counts
from repro_torch.models.param import compute_params, materialize, tree_map
from repro_torch.models.registry import build_model
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graph as graph_mod
from repro_torch.serve.engine import (
    ContinuousBatchingEngine,
    ContinuousConfig,
    ServeConfig,
    ServeEngine,
    draw,
    scaled_logits,
)

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax

    from repro import obs as jobs
    from repro import ops as jops
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
    from repro.serve.engine import ContinuousConfig as JaxConfig
except ImportError:
    jax = None

MAX_LEN = 40
COUNTERS = ("serve.bytes.h2d", "serve.bytes.d2h", "kv.gather.bytes")


@pytest.fixture(scope="module")
def pair():
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    from repro_torch.models.param import from_reference

    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl="pallas")
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                              device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _prompts(seed=7, lens=(5, 11, 8, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens], [4, 2, 5, 3]


def _shared_prefix_prompts(seed=0):
    """Five prompts behind a common 9-token prefix: on 2 slots and 7 blocks
    of 4 rows they hit the prefix cache and force a preemption."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, 256, (9,))
    prompts = [np.concatenate([pre, rng.integers(0, 256, (n,))]).astype(np.int32)
               for n in (3, 7, 2, 11, 5)]
    return prompts, [6, 4, 7, 5, 3]


# ---------------------------------------------------------------------------
# weights cast once


@pytest.mark.parametrize("arch", ["granite_8b", "granite_moe_1b_a400m", "mamba2_130m"])
def test_cast_once_gives_the_bits_of_casting_at_use(arch):
    """bf16 compute over float32 weights: prefill and decode logits from
    the compute-dtype tree equal, bit for bit, those that cast every weight
    where it is used; the read-through-``.float()`` leaves stay float32."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="bfloat16")
    model = build_model(cfg)
    params = materialize(model.param_specs(), 3, "cpu")
    cast = compute_params(params, cfg)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 9)))
    nxt = tokens[:, -1:]
    outs = []
    for p in (params, cast):
        logits, cache = model.prefill(p, tokens, 16)
        if arch != "mamba2_130m":
            pool = model.init_paged_cache(9, 4, 2, device="cpu")
            tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
            for slot in range(2):
                one = {"layers": {k: v[:, slot:slot + 1] for k, v in cache["layers"].items()},
                       "len": cache["len"], "pos": cache["pos"]}
                model.write_slot_paged(pool, one, slot, tables[slot])
            step, _ = model.decode_step_paged(p, pool, nxt, tables, cache_t=16)
        else:
            step, _ = model.decode_step(p, cache, nxt)
        outs.append((logits, step))
    for a, b in zip(*outs):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    blocks = cast["blocks"]
    if arch == "granite_8b":
        bf16 = [blocks["attn"]["wq"], blocks["mlp"]["wg"], cast["embed"]["table"]]
        f32 = [blocks["ln1"]["scale"], cast["final_norm"]["scale"]]
    elif arch == "granite_moe_1b_a400m":  # the router and the experts
        bf16 = [blocks["moe"][n] for n in ("router", "wi", "wg", "wo")]
        f32 = [blocks["ln2"]["scale"], cast["final_norm"]["scale"]]
    else:
        bf16 = [blocks["in_proj"], blocks["out_proj"], blocks["conv"]["kernel"],
                cast["unembed"]["kernel"]]
        f32 = [blocks["A_log"], blocks["D"], blocks["dt_bias"], blocks["out_norm"]]
    assert all(t.dtype == torch.bfloat16 for t in bf16)
    assert all(t.dtype == torch.float32 for t in f32)
    again = compute_params(cast, cfg)  # idempotent: nothing copied twice
    assert tree_map(lambda a, b: a is b, again, cast) == tree_map(lambda a: True, cast)
    same = compute_params(params, get_smoke_config(arch))  # f32 compute: no copy
    assert tree_map(lambda a, b: a is b, same, params) == tree_map(lambda a: True, params)


# ---------------------------------------------------------------------------
# counters and trace against the JAX engine


PLANS = {
    "monolithic": {},
    "prefix_chunked_preempting": dict(prefix_cache=True, prefill_chunk_tokens=4,
                                      kv_pool_blocks=7),
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_counters_trace_and_tokens_match_the_jax_engine(pair, plan):
    """One greedy paged workload on the gather-free route in both packages
    (``pallas_paged``): the same tokens, the same ``serve.bytes.h2d`` /
    ``serve.bytes.d2h`` / ``kv.gather.bytes``, and, restricted to the
    reference's names, the same Chrome events (names, phases, ids, args) —
    timestamps aside; the port's own spans are checked on their own."""
    cfg_j, params_j, cfg_t, params_t = pair
    prompts, gens = _prompts() if plan == "monolithic" else _shared_prefix_prompts()
    kw = PLANS[plan]
    tj, tt = jobs.Tracer(), obs.Tracer()
    with jops.use(softmax="pallas"):
        ej = JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN,
                                                  kv_layout="paged", kv_block_size=4, **kw),
                       tracer=tj)
        want = ej.serve(prompts, gens)
    with ops.use(softmax="pallas"):
        et = ContinuousBatchingEngine(
            cfg_t, params_t, ContinuousConfig(num_slots=2, max_len=MAX_LEN, kv_layout="paged",
                                              kv_block_size=4, **kw),
            device="cpu", tracer=tt)
        got = et.serve(prompts, gens)
    assert got == want and et.ticks == ej.ticks
    assert [et.metrics.counter(n).value() for n in COUNTERS] == \
        [ej.metrics.counter(n).value() for n in COUNTERS]
    assert et.kv_stats()["gather_bytes"] == ej.kv_stats()["gather_bytes"]

    def rows(tracer):
        return [(e["name"], e["ph"], e.get("id"), e.get("args"))
                for e in tracer.chrome_trace()["traceEvents"]]

    ref_names = {r[0] for r in rows(tj)}
    assert [r for r in rows(tt) if r[0] in ref_names] == rows(tj)
    own = {r[0] for r in rows(tt)} - ref_names
    assert own == set(PORT_SPANS) - ({"serve.prefill.device"} if plan != "monolithic" else set())
    _check_port_spans(tt, et.ticks, et.metrics.counter("serve.requests.admitted").value(),
                      monolithic=plan == "monolithic")
    if plan != "monolithic":
        assert et.preemptions >= 1 and et.kv_stats()["prefix"]["hits"] >= 1
        assert any(name == "serve.preempt" for name, *_ in rows(tt))
    # one capture for the engine's one route; one replay per tick
    assert et.graph_entries() == 1 and et.graphs.replays == et.ticks


PORT_SPANS = ("serve.tick.upload", "serve.tick.graph", "serve.tick.sample",
              "serve.tick.record", "serve.tick.device", "serve.prefill.device",
              "serve.queue_wait")
TICK_PHASES = PORT_SPANS[:4]


def _check_port_spans(tracer, ticks, admissions, monolithic, device_ms=False):
    """The port's own spans: one of each tick phase a tick, in order and
    inside its ``serve.decode``; one ``serve.tick.device`` a tick (arg
    ``tick``) covering the replay through the tokens' transfer; one
    ``serve.queue_wait`` an admission; one ``serve.prefill.device`` a
    monolithic admission inside its ``serve.prefill`` through the first
    token's transfer; ``device_ms`` only where there are CUDA events."""
    ev = tracer.chrome_trace()["traceEvents"]
    decode_b = [e for e in ev if e["name"] == "serve.decode" and e["ph"] == "B"]
    decode_e = [e for e in ev if e["name"] == "serve.decode" and e["ph"] == "E"]
    assert len(decode_b) == len(decode_e) == ticks
    for b, e in zip(decode_b, decode_e):
        inside = [x for x in ev if x["ph"] == "X" and b["ts"] <= x["ts"]
                  and x["ts"] + x["dur"] <= e["ts"]]
        assert [x["name"] for x in inside if x["name"] in TICK_PHASES] == list(TICK_PHASES)
        graph = next(x for x in inside if x["name"] == "serve.tick.graph")
        sample = next(x for x in inside if x["name"] == "serve.tick.sample")
        dev = next(x for x in ev if x["name"] == "serve.tick.device"
                   and x["args"]["tick"] == b["args"]["tick"])
        assert dev["ts"] >= graph["ts"] and dev["ts"] + dev["dur"] >= sample["ts"] + sample["dur"]
        assert dev["ts"] + dev["dur"] <= e["ts"]
        assert ("device_ms" in dev["args"]) == device_ms
        if device_ms:
            assert 0 < dev["args"]["device_ms"] <= dev["dur"] * 1e-3
    waits = [x for x in ev if x["name"] == "serve.queue_wait"]
    assert len(waits) == admissions
    assert all(x["ph"] == "X" and x["dur"] >= 0 and set(x["args"]) == {"uid"} for x in waits)
    admits = [x for x in ev if x["name"] == "serve.admit"]
    for w in waits:  # ends at the admission's reading, before its instant
        admit = next(a for a in admits if a["args"]["uid"] == w["args"]["uid"]
                     and a["ts"] >= w["ts"] + w["dur"])
        assert admit["ts"] - (w["ts"] + w["dur"]) < 1e5
    prefills = [x for x in ev if x["name"] == "serve.prefill"]
    devices = [x for x in ev if x["name"] == "serve.prefill.device"]
    assert len(devices) == (len(prefills) if monolithic else 0)
    for p, d in zip(prefills, devices):
        assert {k: d["args"][k] for k in ("uid", "rows")} == p["args"]
        assert p["ts"] <= d["ts"] <= p["ts"] + p["dur"] <= d["ts"] + d["dur"]
        assert ("device_ms" in d["args"]) == device_ms
        if device_ms:
            assert 0 < d["args"]["device_ms"] <= d["dur"] * 1e-3


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_port_spans_nest_in_the_tick_on_cpu(layout, temperature):
    """The tick's phases nest inside ``serve.decode`` and the deferred spans
    carry their args, on either pool, greedy or sampled."""
    cfg = get_smoke_config("granite_8b")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    tracer = obs.Tracer()
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, kv_layout=layout, temperature=temperature),
        device="cpu", tracer=tracer)
    prompts, gens = _prompts()
    assert all(len(o) == n for o, n in zip(eng.serve(prompts, gens), gens))
    _check_port_spans(tracer, eng.ticks, len(prompts), monolithic=True)


def test_steady_decode_uploads_only_the_token_inputs():
    """A tick that opens no block uploads the ``[S, 1]`` int32 inputs and no
    table bytes, and brings down the ``[S]`` sampled vector; a tick whose
    KV write opens a block adds that slot's ``W``-entry row."""
    cfg = get_smoke_config("granite_8b")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    s, bs = 2, 16
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=s, max_len=MAX_LEN, kv_layout="paged", kv_block_size=bs), device="cpu")
    w = eng._slot_blocks
    for n in (12, 5):
        eng.submit(np.arange(1, n + 1), 12)
    eng.step()  # admissions (prompt tokens, write tables, dirty rows) and tick 0
    h2d, d2h, flushed = (eng.metrics.counter(n) for n in
                         ("serve.bytes.h2d", "serve.bytes.d2h", "serve.tables.rows_flushed"))
    assert flushed.value() == s  # both admitted rows went up once
    seen = set()
    for _ in range(8):
        rows = eng._rows.copy()
        opens = int(sum(r % bs == 0 for r in rows))  # KV writes opening a block
        before = (h2d.value(), d2h.value(), flushed.value())
        eng.step()
        assert h2d.value() - before[0] == s * 4 + opens * w * 4
        assert d2h.value() - before[1] == s * 4
        assert flushed.value() - before[2] == opens
        seen.add(opens)
    assert seen == {0, 1}  # steady ticks and a tick that grew a table


def test_disabled_tracer_records_nothing_during_serve():
    cfg = get_smoke_config("granite_8b")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    assert obs.get_tracer() is obs.NULL_TRACER
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, kv_layout="paged"), device="cpu")
    assert eng.tracer is obs.NULL_TRACER
    assert all(len(o) == 3 for o in eng.serve([np.arange(4), np.arange(6)], 3))
    assert obs.NULL_TRACER.events == [] and obs.NULL_TRACER.chrome_trace()["traceEvents"] == []
    assert eng.metrics.counter("serve.requests.finished").value() == 2


def _refuse(*args, **kwargs):
    raise AssertionError("opened under the no-op tracer")


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_null_tracer_opens_no_range_makes_no_event_and_reads_no_clock(device, monkeypatch):
    """Under the no-op tracer a serve opens no profiler range, makes no CUDA
    event and reads the engine's clock only where the reference's engine
    does: once at each submit, admission and token."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    from repro_torch.obs import trace

    monkeypatch.setattr(trace, "_open_range", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
    reads = []

    def clock():
        reads.append(1)
        return float(len(reads))

    cfg = get_smoke_config("granite_8b")
    params = materialize(build_model(cfg).param_specs(), 0, device)
    for layout in ("paged", "dense"):
        reads.clear()
        eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, kv_layout=layout, temperature=0.8),
            device=device, clock=clock)
        prompts, gens = _prompts()
        eng.serve(prompts, gens)
        assert len(reads) == 2 * len(prompts) + sum(gens)


# ---------------------------------------------------------------------------
# the traffic model


@pytest.mark.parametrize("impl", ["pallas_paged", "xla", "reference", "pallas"])
@pytest.mark.parametrize("dtype_bytes,scale", [(4, 0), (2, 0), (1, 16)])
def test_paged_gather_bytes_matches_the_reference(impl, dtype_bytes, scale):
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    rng = np.random.default_rng(dtype_bytes + scale)
    for _ in range(20):
        s, w, bs = (int(x) for x in rng.integers(1, 9, 3))
        lens = rng.integers(0, w * bs + 1, s)
        kw = dict(table_width=w, block_size=bs, live_lens=lens, num_kv_heads=2, head_dim=16,
                  dtype_bytes=dtype_bytes, scale_bytes_per_block=scale)
        assert ops.paged_gather_bytes(impl, **kw) == jops.paged_gather_bytes(impl, **kw)


# ---------------------------------------------------------------------------
# the graph helper


class FakeGraph:
    """A stand-in capture object: ``capture`` runs the step once (as a
    recording would, so its launches land in the graph's tally) and keeps
    its outputs; ``replay`` returns them."""

    made = []

    def __init__(self, device, stream):
        self.warmed = self.captured = self.replays = 0
        FakeGraph.made.append(self)

    def warmup(self, fn):
        self.warmed += 1
        fn()

    def capture(self, fn):
        self.captured += 1
        self.outputs = fn()

    def replay(self):
        self.replays += 1
        return self.outputs


class FailingGraph(FakeGraph):
    def capture(self, fn):
        raise RuntimeError("operation not permitted when stream is capturing")


def test_graph_replays_add_the_captured_launch_tally():
    FakeGraph.made.clear()
    counter = _cuda.launch_counter("paged_attention")
    graphs = graph_mod.StepGraphs("cpu", graph_factory=FakeGraph)
    reset_launch_counts()

    def step():  # what a tick's wrappers record: two kernel launches
        counter.add()
        counter.add()
        return "out"

    outs = [graphs.run(("tick", 4), step, step) for _ in range(5)]
    assert outs == ["out"] * 5
    (g,) = FakeGraph.made
    assert (g.warmed, g.captured, g.replays) == (1, 1, 5)
    assert launch_counts()["paged_attention"] == 5 * 2  # n replays x the tally
    assert graphs.warmup_launches() == {"paged_attention": 2}  # reported apart
    assert (graphs.replays, graphs.entries()) == (5, 1)
    # another route, or the same one under another ops.use override, captures anew
    graphs.run(("tick", 8), step, step)
    with ops.use(paged_attention="reference"):
        graphs.run(("tick", 4), step, step)
        graphs.run(("tick", 4), step, step)
    graphs.run(("tick", 4), step, step)  # the first graph again, not a stale one
    assert graphs.entries() == 3 and len(FakeGraph.made) == 3
    assert FakeGraph.made[0].replays == 6 and FakeGraph.made[2].replays == 2
    assert launch_counts()["paged_attention"] == 9 * 2
    reset_launch_counts()


def test_failed_capture_raises_naming_the_route():
    graphs = graph_mod.StepGraphs("cpu", graph_factory=FailingGraph)
    with ops.use(softmax="pallas"):
        with pytest.raises(graph_mod.GraphCaptureError, match=r"'tick'.*'softmax', 'pallas'"):
            graphs.run(("tick", 4), lambda: None, lambda: None)
    assert graphs.entries() == 0


def test_engine_graph_key_follows_the_ops_use_route():
    """The tick's route is resolved at capture: a tick under another
    ``ops.use`` captures its own graph (counted), and one back under the
    first route replays the first graph.  Sampling under a guard is eager,
    decided from the config."""
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, kv_layout="paged"), device="cpu")
    eng.submit(np.arange(5), 6)
    eng.step()
    with ops.use(paged_attention="reference"):
        eng.step()
    eng.step()
    assert eng.graph_entries() == 2 and eng.graphs.replays == eng.ticks == 3
    assert eng.metrics.gauge("serve.graph.entries").value() == 2
    guarded = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, temperature=0.8, kv_layout="paged",
        guard=ops.GuardConfig()), device="cpu")
    assert guarded._route[4] == "eager sampling" and eng._route[4] == "greedy"
    guarded.serve([np.arange(5)], 4)
    assert guarded.guard.calls == 4  # every sampled batch went through the guard


# ---------------------------------------------------------------------------
# state in place, launch tallies, sampling


def test_decode_steps_update_their_state_in_place():
    cfg = get_smoke_config("granite_8b")
    model = build_model(cfg)
    params = materialize(model.param_specs(), 0, "cpu")
    pool = model.init_paged_cache(5, 4, 2, device="cpu")
    ln, pos = pool["len"], pool["pos"]
    pool["len"][0] = pool["pos"][0] = 3
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    _, out = model.decode_step_paged(params, pool, torch.tensor([[1], [2]]), tables, cache_t=8)
    assert out is pool and out["len"] is ln and out["pos"] is pos
    assert ln.tolist() == [4, 1] and pos.tolist() == [4, 1]
    mcfg = get_smoke_config("mamba2_130m")
    mamba = build_model(mcfg)
    mparams = materialize(mamba.param_specs(), 0, "cpu")
    _, cache = mamba.prefill(mparams, torch.tensor([[1, 2, 3, 4]]), 16)
    conv, ssm, mlen = cache["layers"]["conv"], cache["layers"]["ssm"], cache["len"]
    _, out = mamba.decode_step(mparams, cache, torch.tensor([[5]]))
    assert out is cache and out["len"] is mlen and int(mlen) == 5
    assert out["layers"]["conv"] is conv and out["layers"]["ssm"] is ssm


def test_launches_into_tallies_instead_of_counting():
    reset_launch_counts()
    c = _cuda.launch_counter("star_softmax")
    outer, inner = {}, {}
    with _cuda.launches_into(outer):
        c.add()
        with _cuda.launches_into(inner):
            c.add()
            c.add()
    c.add()
    assert (outer, inner, launch_counts()["star_softmax"]) == (
        {"star_softmax": 1}, {"star_softmax": 2}, 1)
    _cuda.add_launches(inner)
    assert launch_counts()["star_softmax"] == 3
    reset_launch_counts()


def test_scaled_logits_divide_by_a_tensor():
    """``logits / T`` is an IEEE division by a tensor: float32 quotients
    equal the float64 quotient rounded once (exact for division), which a
    multiply by the reciprocal of T misses on some inputs."""
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(4, 49152)) * 8,
                        dtype=torch.float32)
    t = torch.full((), 0.7, dtype=torch.float32)
    got = scaled_logits(x, t)
    assert torch.equal(got, (x.double() / t.double()).float())
    assert not torch.equal(got, x * (1.0 / t))  # the reciprocal moves some bits


def test_draw_is_multinomials_draw_without_its_host_checks():
    probs = torch.softmax(torch.as_tensor(np.random.default_rng(6).normal(size=(3, 300)) * 2,
                                          dtype=torch.float32), dim=-1)
    got = draw(probs, [torch.Generator().manual_seed(i) for i in range(3)])
    want = [int(torch.multinomial(probs[i], 1, generator=torch.Generator().manual_seed(i)))
            for i in range(3)]
    assert got.dtype == torch.int32 and got.tolist() == want


@pytest.mark.parametrize("bad", ["nan", "inf", "negative", "zeros"])
def test_draw_marks_a_row_multinomial_refuses(bad):
    """A row ``torch.multinomial`` raises on draws ``INVALID_TOKEN``; the
    other rows draw as before, and ``check_drawn`` raises on the result."""
    probs = torch.softmax(torch.as_tensor(np.random.default_rng(6).normal(size=(3, 300)),
                                          dtype=torch.float32), dim=-1)
    broken = probs.clone()
    if bad == "zeros":
        broken[1] = 0.0
    else:
        broken[1, 17] = {"nan": float("nan"), "inf": float("inf"), "negative": -1e-3}[bad]
    with pytest.raises(RuntimeError):
        torch.multinomial(broken[1], 1)
    gens = lambda: [torch.Generator().manual_seed(i) for i in range(3)]  # noqa: E731
    got, want = draw(broken, gens()), draw(probs, gens())
    assert got.tolist() == [want[0], engine_mod.INVALID_TOKEN, want[2]]
    engine_mod.check_drawn(want.numpy())
    with pytest.raises(RuntimeError, match=r"NaN.*\[\[1\]\]|\[\[1\]\].*NaN"):
        engine_mod.check_drawn(got.numpy())


def _nan_after(n_real, monkeypatch):
    """``sampling_probs`` as the engines call it, giving NaN rows from its
    ``n_real + 1``-th call on (a faulty softmax)."""
    real, calls = engine_mod.sampling_probs, []

    def probs(*args, **kwargs):
        calls.append(1)
        out = real(*args, **kwargs)
        return out if len(calls) <= n_real else torch.full_like(out, float("nan"))

    monkeypatch.setattr(engine_mod, "sampling_probs", probs)


@pytest.mark.parametrize("n_real", [0, 1], ids=["first sample", "tick"])
def test_continuous_serve_raises_on_a_nan_distribution(n_real, monkeypatch):
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, temperature=0.8, kv_layout="paged"), device="cpu")
    eng.submit(np.arange(5), 6)
    _nan_after(n_real, monkeypatch)
    with pytest.raises(RuntimeError, match="NaN"):
        for _ in range(3):
            eng.step()


def test_lockstep_generate_raises_on_a_nan_distribution(monkeypatch):
    cfg = get_smoke_config("mamba2_130m")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    eng = ServeEngine(cfg, params, ServeConfig(max_len=32, temperature=0.8), device="cpu")
    _nan_after(2, monkeypatch)
    with pytest.raises(RuntimeError, match="NaN"):
        eng.generate(np.arange(12).reshape(2, 6), 5)


# ---------------------------------------------------------------------------
# on the card


def _eager_vs_replay(eng):
    """The tick's outputs by graph replay against the eager tick from a copy
    of the same state (pool, inputs, tables)."""
    eng._upload_tick_inputs()
    state = [None if t is None else tree_map(torch.clone, t) for t in eng._tick_state()]
    eager = eng._tick_body(*state)
    replay = eng._decode()
    return eager, replay, state


MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01, adc_offset_sigma=0.1,
            read_disturb=0.01, seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,fault", [("fp32", False), ("int8", False),
                                            ("fp8_e4m3", False), ("fp32", True)])
def test_graph_tick_equals_the_eager_tick_on_card(cuda, kv_dtype, fault):
    """Smoke widths, 2 slots mid-decode: the replayed tick's logits and
    greedy tokens (or, sampled, its sampling distribution) equal the eager
    tick's from a copy of the same state, and the pool it leaves equals the
    eager copy's.  With a fault (mild, histogram, no guard: attention rows
    on the ``reference`` path, the faulty STAR sampling kernel) the faulty
    tables made once per device replay in the graph."""
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    temperature = 0.0
    if fault:
        base = get_smoke_config("granite_8b")
        cfg = dataclasses.replace(base, softmax=dataclasses.replace(
            base.softmax_spec, fault=ops.FaultModel(**MILD), mode="histogram"))
        temperature = 0.8
    params = materialize(build_model(cfg).param_specs(), 0, "cuda")
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4, kv_dtype=kv_dtype,
        temperature=temperature), device="cuda")
    prompts, _ = _prompts(lens=(9, 6))
    with ops.use(softmax="pallas"):
        for p in prompts:
            eng.submit(p, 20)
        for _ in range(3):
            eng.step()
        (out_e, last_e), (out_r, last_r), state = _eager_vs_replay(eng)
    torch.cuda.synchronize()
    assert eng.graph_entries() == 1 and eng.graphs.replays == 4
    assert torch.equal(last_r, last_e) and torch.equal(out_r, out_e)
    for name, leaf in eng.pool["layers"].items():
        ref = state[0]["layers"][name]
        if leaf.element_size() == 1:
            leaf, ref = leaf.view(torch.uint8), ref.view(torch.uint8)
        assert torch.equal(leaf, ref), name
    assert torch.equal(eng.pool["len"], state[0]["len"])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_device_ms_is_positive_and_inside_its_span_on_card(cuda, layout):
    """On the card the tick's and the admissions' device-timed spans carry
    ``device_ms`` from their CUDA events, above 0 and below the span's wall;
    the spans nest as on the CPU."""
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cuda")
    tracer = obs.Tracer()
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, kv_layout=layout, temperature=0.8),
        device="cuda", tracer=tracer)
    prompts, gens = _prompts()
    with ops.use(softmax="pallas"):
        assert all(len(o) == n for o, n in zip(eng.serve(prompts, gens), gens))
    assert eng.graph_entries() == 1
    _check_port_spans(tracer, eng.ticks, len(prompts), monolithic=True, device_ms=True)


@pytest.mark.cuda
def test_dense_tick_and_lockstep_graphs_on_card(cuda):
    """The dense layout on the card: a tick's replay equals the eager tick
    from a copy of the same state and leaves the same pool; served greedy,
    flash_star launches once per layer of every prefill and every tick
    (through the replays) and the tokens equal the CPU's; the lockstep
    granite engine's tokens too."""
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    gpu = tree_map(lambda t: t.cuda(), params)
    eng = ContinuousBatchingEngine(cfg, gpu, ContinuousConfig(num_slots=2, max_len=MAX_LEN),
                                   device="cuda")
    for p in _prompts(lens=(9, 6))[0]:
        eng.submit(p, 20)
    for _ in range(3):
        eng.step()
    (out_e, last_e), (out_r, last_r), state = _eager_vs_replay(eng)
    torch.cuda.synchronize()
    assert torch.equal(last_r, last_e) and torch.equal(out_r, out_e)
    for name, leaf in eng.pool["layers"].items():
        assert torch.equal(leaf, state[0]["layers"][name]), name
    prompts, gens = _prompts()
    outs = {}
    for dev, p in (("cuda", gpu), ("cpu", params)):
        e = ContinuousBatchingEngine(cfg, p, ContinuousConfig(num_slots=2, max_len=MAX_LEN),
                                     device=dev)
        reset_launch_counts()
        outs[dev] = e.serve(prompts, gens)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert e.graph_entries() == 1 and e.graphs.replays == e.ticks
            assert launch_counts()["flash_star"] == cfg.num_layers * (len(prompts) + e.ticks)
    assert outs["cuda"] == outs["cpu"]
    lock = np.random.default_rng(12).integers(0, 256, (2, 9))
    got = [ServeEngine(cfg, p, ServeConfig(max_len=MAX_LEN), device=dev).generate(lock, 8)[0]
           for dev, p in (("cuda", gpu), ("cpu", params))]
    assert torch.equal(got[0].cpu(), got[1])


@pytest.mark.cuda
def test_launch_counts_hold_under_replay_on_card(cuda):
    """Served greedy on the card: one capture, replays == ticks, the paged
    kernel once per layer of every tick (counted through replays), tokens
    equal to the CPU's."""
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    prompts, gens = _prompts()
    outs = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cpu" else tree_map(lambda t: t.cuda(), params)
        eng = ContinuousBatchingEngine(cfg, p, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4), device=dev)
        reset_launch_counts()
        outs[dev] = eng.serve(prompts, gens)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = launch_counts()
            assert eng.graph_entries() == 1 and eng.graphs.replays == eng.ticks
            assert counts["paged_attention"] == cfg.num_layers * eng.ticks
            assert eng.graphs.warmup_launches()["paged_attention"] == cfg.num_layers
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_lockstep_mamba_graph_on_card(cuda, temperature):
    """The lockstep decode step captured once per generate: greedy tokens
    equal the CPU's; sampled tokens equal an eager decode loop's with the
    same generators; the softmax kernel once per sampled step."""
    cfg = get_smoke_config("mamba2_130m")
    model = build_model(cfg)
    params = materialize(model.param_specs(), 0, "cpu")
    gpu = tree_map(lambda t: t.cuda(), params)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (3, 21))
    sc = ServeConfig(max_len=64, temperature=temperature)
    gen = 8
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg, gpu, sc, device="cuda", seed=4)
        reset_launch_counts()
        got, info = eng.generate(prompts, gen)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert (eng.graphs.entries(), eng.graphs.replays) == (1, gen - 1)
        assert info["cache_len"] == 21 + gen - 1
        if temperature == 0.0:
            cpu, _ = ServeEngine(cfg, params, sc, device="cpu").generate(prompts, gen)
            assert got.cpu().tolist() == cpu.tolist()
        else:
            assert counts.get("star_softmax", 0) == gen
            from repro_torch.serve.engine import sample_token

            gens = [torch.Generator(device="cuda").manual_seed(4 + i) for i in range(3)]
            cp = compute_params(gpu, cfg)
            logits, cache = model.prefill(cp, torch.as_tensor(prompts, device="cuda"), 64)
            toks = [sample_token(logits[:, -1], gens, cfg, temperature)]
            for _ in range(gen - 1):
                logits, cache = model.decode_step(cp, cache, toks[-1][:, None])
                toks.append(sample_token(logits[:, -1], gens, cfg, temperature))
            assert got.tolist() == torch.stack(toks, 1).tolist()


@pytest.mark.cuda
def test_scaled_logits_card_equals_cpu_bit_for_bit(cuda):
    x = torch.as_tensor(np.random.default_rng(12).normal(size=(4, 49152)) * 8,
                        dtype=torch.float32)
    for temp in (0.8, 0.7, 1.3):
        t_cpu = torch.full((), temp, dtype=torch.float32)
        got = scaled_logits(x.to(cuda), t_cpu.to(cuda)).cpu()
        assert torch.equal(got, scaled_logits(x, t_cpu))
