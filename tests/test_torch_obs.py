"""The port's observability (``repro_torch.obs``) against the reference's
``repro.obs``: the tracer's Chrome events for the same call sequence on a
fake clock, the metrics primitives case by case (the cases of
``tests/test_obs.py``, run through both packages), the dispatch counter and
the guard's trip instant, and the launcher's ``--trace-out`` /
``--metrics-out`` on the CPU smoke config.  Pure host-side, no model but
the launcher's."""

import json
import warnings

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs, ops
from repro_torch.launch import serve as launcher

RNG = np.random.default_rng(0)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _clean_globals():
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _engine_like_sequence(tr, clk):
    """What an engine tick writes: instants, async tracks, a span, a B/E
    pair and counter samples."""
    tr.instant("serve.submit", uid=0, prompt_len=5, max_new_tokens=3)
    tr.async_begin("request", 0)
    clk.advance(0.001)
    tr.instant("serve.admit", uid=0, slot=0, rows=5)
    with tr.span("serve.prefill", uid=0, rows=5):
        clk.advance(0.0125)
    tr.begin("serve.decode", tick=0, uids=[0])
    clk.advance(0.003)
    tr.end("serve.decode")
    tr.instant("guard.trip", cat="guard", op="softmax", impl="pallas", error=0.5,
               tolerance=0.1, fallback="reference")
    tr.instant("serve.finish", uid=0, tokens=3)
    tr.async_end("request", 0)
    tr.counter("serve.sched", pending=0, active=1)
    tr.counter("kv.blocks", used=2)


@pytest.mark.parametrize("capacity", [65536, 4])
def test_tracer_events_match_the_reference_on_a_fake_clock(capacity):
    """The same calls give the same Chrome events, field for field
    (``tid`` is this thread's id in both); a small ring drops the same
    oldest events and counts them alike."""
    docs = []
    for pkg in (obs, jobs):
        clk = FakeClock(2.0)
        tr = pkg.Tracer(capacity=capacity, clock=clk)
        _engine_like_sequence(tr, clk)
        docs.append(tr.chrome_trace())
    assert docs[0] == docs[1]
    assert docs[0]["otherData"]["dropped_events"] == (0 if capacity > 11 else 11 - capacity)


def test_tracer_export_loads_and_null_tracer_allocates_nothing(tmp_path):
    clk = FakeClock()
    tr = obs.Tracer(clock=clk)
    _engine_like_sequence(tr, clk)
    loaded = json.load(open(tr.export_chrome(str(tmp_path / "t.json"))))
    assert loaded["traceEvents"] == tr.chrome_trace()["traceEvents"]
    x = next(e for e in loaded["traceEvents"] if e["ph"] == "X")
    assert x["dur"] == pytest.approx(12_500)  # microseconds
    null = obs.get_tracer()
    assert null is obs.NULL_TRACER and not null.enabled
    assert null.span("a", uid=1) is null.span("b")  # one shared span object
    _engine_like_sequence(null, FakeClock())
    assert null.events == [] and null.chrome_trace()["traceEvents"] == []
    assert obs.enable_tracing(capacity=8) is obs.get_tracer()
    obs.disable_tracing()
    assert obs.get_tracer() is obs.NULL_TRACER
    with pytest.raises(ValueError, match="capacity"):
        obs.Tracer(capacity=0)


@pytest.mark.parametrize("args", [{}, {"uid": 3, "device_ms": 1.25}])
def test_complete_writes_the_references_span_row_on_a_fake_clock(args):
    """``complete`` from two readings of ``now()`` gives the row the
    reference's ``span`` gives over the same readings, field for field; the
    no-op tracer's ``complete`` records nothing and reads no clock."""
    rows = []
    for pkg in (obs, jobs):
        clk = FakeClock(2.0)
        tr = pkg.Tracer(clock=clk)
        clk.advance(0.5)
        if pkg is obs:
            start = tr.now()
            clk.advance(0.0125)
            tr.complete("serve.queue_wait", start, tr.now(), **args)
        else:
            with tr.span("serve.queue_wait", **args):
                clk.advance(0.0125)
        rows.append(tr.chrome_trace()["traceEvents"])
    assert rows[0] == rows[1]
    assert rows[0][0]["ts"] == pytest.approx(500_000) and rows[0][0]["dur"] == pytest.approx(12_500)
    null = obs.NULL_TRACER
    null.complete("serve.queue_wait", null.now(), null.now(), uid=1)
    assert null.now() == 0.0 and null.events == []


def test_spans_are_profiler_ranges_of_their_names():
    """Under ``torch.profiler.profile`` on the CPU the profiler's host events
    carry the program's span names, nested as the spans are; ``complete``
    opens no range and the events the tracer records are unchanged."""
    from torch.profiler import ProfilerActivity, profile

    clk = FakeClock()
    tr = obs.Tracer(clock=clk)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.begin("serve.decode", tick=0)
        with tr.span("serve.tick.graph"):
            torch.ones(4).sum()
        tr.end("serve.decode")
        tr.complete("serve.tick.device", 0.0, 0.0, tick=0)
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("serve.")}
    assert set(ranges) == {"serve.decode", "serve.tick.graph"}
    outer, inner = ranges["serve.decode"], ranges["serve.tick.graph"]
    assert outer.start <= inner.start and inner.end <= outer.end
    sums = [e.time_range for e in prof.events() if e.name == "aten::sum"]
    assert sums and inner.start <= sums[0].start and sums[0].end <= inner.end
    assert [(e.name, e.ph) for e in tr.events] == [
        ("serve.decode", "B"), ("serve.tick.graph", "X"), ("serve.decode", "E"),
        ("serve.tick.device", "X")]
    assert tr._ranges == {"serve.decode": []}  # every range closed


# ---------------------------------------------------------------------------
# metrics: the reference's cases, through both packages


def _counter_labels(pkg):
    c = pkg.Counter("calls")
    c.inc(op="softmax", impl="pallas")
    c.inc(2, impl="pallas", op="softmax")
    c.inc(op="matmul", impl="xla")
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    return c.snapshot(), c.value(op="softmax", impl="pallas"), c.value(op="missing")


def _gauge_set_inc_dec(pkg):
    g = pkg.Gauge("depth")
    g.set(5)
    g.inc(2)
    g.dec()
    g.set(1, slot=3)
    return g.snapshot(), g.value(), g.value(slot=3)


def _log_buckets(pkg):
    with pytest.raises(ValueError):
        pkg.log_buckets(0, 1)
    with pytest.raises(ValueError):
        pkg.log_buckets(1e-3, 1.0, per_decade=0)
    return pkg.log_buckets(1e-3, 1.0, per_decade=1), pkg.DEFAULT_TIME_BUCKETS


def _histogram_percentiles(pkg):
    h = pkg.Histogram("lat", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.5, 1.5, 3.0, 10.0):  # 10.0 in the overflow bucket
        h.observe(v)
    return h.snapshot(), [h.percentile(p) for p in (0, 10, 50, 90, 95, 99, 100)], h.count()


def _histogram_default_buckets(pkg):
    h = pkg.Histogram("ttft")
    for v in RNG_VALUES:
        h.observe(float(v))
        h.observe(float(v) * 2, route="b")
    return h.snapshot(), [h.percentile(p, route="b") for p in (50, 95, 99)]


def _histogram_empty_and_single(pkg):
    h = pkg.Histogram("lat", buckets=(1.0, 2.0))
    h.observe(7.25)  # one sample in the overflow bucket: exact everywhere
    h._get({"route": "b"})  # an empty series: no inf sentinel may leak
    with pytest.raises(ValueError, match="percentile"):
        h.percentile(101)
    with pytest.raises(ValueError, match="increase"):
        pkg.Histogram("bad", buckets=(2.0, 1.0))
    snap = h.snapshot()
    json.dumps(snap)
    return snap, pkg.Histogram("e").percentile(50)


def _registry(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("x", help="calls")
    assert reg.counter("x") is c
    with pytest.raises(ValueError, match="already registered") as exc:
        reg.gauge("x")
    reg.gauge("g").set(3)
    reg.histogram("h").observe(0.1)
    c.inc(op="a")
    snap = reg.snapshot()
    names = reg.names()
    reg.clear()
    return snap, names, reg.snapshot(), str(exc.value)


def _default_registry_swap(pkg):
    mine = pkg.MetricsRegistry()
    prev = pkg.set_default_registry(mine)
    try:
        swapped = pkg.default_registry() is mine
    finally:
        pkg.set_default_registry(prev)
    return swapped, pkg.default_registry() is prev


RNG_VALUES = RNG.lognormal(-4.0, 1.5, size=200)
METRIC_CASES = [_counter_labels, _gauge_set_inc_dec, _log_buckets, _histogram_percentiles,
                _histogram_default_buckets, _histogram_empty_and_single, _registry,
                _default_registry_swap]


@pytest.mark.parametrize("case", METRIC_CASES, ids=lambda f: f.__name__.lstrip("_"))
def test_metrics_match_the_reference(case):
    """Snapshots, values, percentiles (the reference's bucket rule) and
    error messages equal the reference's for the same calls."""
    assert case(obs) == case(jobs)


# ---------------------------------------------------------------------------
# producers: the dispatch counter and the guard's trip instant


def test_dispatch_counts_resolved_backend_labels():
    mine = obs.MetricsRegistry()
    prev = obs.set_default_registry(mine)
    try:
        x = torch.ones((2, 8))
        ops.softmax(x)  # default spec -> reference
        with ops.use(softmax="xla"):
            ops.softmax(x, kind="exact")  # the override's impl is counted
        c = mine.counter("ops.dispatch.calls")
        assert c.value(op="softmax", impl="reference") == 1
        assert c.value(op="softmax", impl="xla") == 1
    finally:
        obs.set_default_registry(prev)


def test_guard_trip_counts_and_marks_a_trace_instant():
    mine = obs.MetricsRegistry()
    prev = obs.set_default_registry(mine)
    tracer = obs.enable_tracing()
    try:
        x = torch.as_tensor(RNG.normal(size=(4, 32)) * 4, dtype=torch.float32)
        guard = ops.AccuracyGuard(ops.GuardConfig(tolerance=1e-12))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ops.GuardTripWarning)
            ops.softmax(x, ops.SoftmaxSpec(), guard=guard)  # star vs exact
        assert guard.tripped
        assert mine.counter("ops.guard.trips").value(op="softmax", impl="reference") == 1
        (ev,) = [e for e in tracer.events if e.name == "guard.trip"]
        assert (ev.ph, ev.cat, ev.args["op"], ev.args["fallback"]) == (
            "i", "guard", "softmax", "reference")
        assert ev.args["error"] > ev.args["tolerance"] == 1e-12
    finally:
        obs.set_default_registry(prev)


# ---------------------------------------------------------------------------
# the launcher


REFERENCE_NAMES = {"serve.submit", "serve.admit", "serve.prefill", "serve.decode",
                   "serve.finish", "request", "serve.sched", "kv.blocks"}


@pytest.mark.parametrize("extra,names", [
    ([], REFERENCE_NAMES),
    (["--prefix-cache", "--prefill-chunk-tokens", "8", "--kv-pool-blocks", "6"],
     REFERENCE_NAMES - {"serve.prefill"} | {"serve.prefill_chunk"}),
])
def test_launcher_writes_trace_and_metrics_json(tmp_path, capsys, extra, names):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    rc = launcher.main(["--arch", "granite_8b", "--smoke", "--device", "cpu",
                        "--engine", "continuous", "--kv-layout", "paged", "--requests", "4", "--prompt-len", "24", "--gen", "6",
                        "--trace-out", str(trace), "--metrics-out", str(metrics), *extra])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"trace events to {trace}" in out and f"metrics snapshot to {metrics}" in out
    doc = json.load(open(trace))
    seen = {e["name"] for e in doc["traceEvents"]}
    assert names <= seen
    assert {e["ph"] for e in doc["traceEvents"]} >= {"i", "X", "B", "E", "b", "e", "C"}
    snap = json.load(open(metrics))
    assert set(snap) == {"engine", "global"}
    eng = snap["engine"]
    assert eng["graphs"]["entries"] == 1 and eng["graphs"]["replays"] == eng["ticks"]
    m = eng["metrics"]
    for name in ("serve.bytes.h2d", "serve.bytes.d2h", "kv.gather.bytes"):
        (series,) = m[name]["series"]
        assert m[name]["kind"] == "counter" and series["value"] > 0
    (ttft,) = m["serve.ttft_s"]["series"]
    assert ttft["count"] == 4 and {"p50", "p95", "p99", "min", "max", "sum"} <= set(ttft)
    assert m["serve.graph.entries"]["series"] == [{"labels": {}, "value": 1}]
    dispatch = snap["global"]["ops.dispatch.calls"]["series"]
    assert {(s["labels"]["op"], s["labels"]["impl"]) for s in dispatch} >= {
        ("attention", "xla"), ("paged_attention", "xla")}
    assert obs.get_tracer().enabled  # enabled before the engine was built
