"""The readers of the engine's own spans: the tick split into its graph's
device time and the host's rest, the admissions' device time and the exact
queue-wait tail, on hand-built runs; and the spans a real engine records on
the CPU read through ``spans_of`` (no CUDA events there: the device readers
give nothing)."""

import numpy as np
import pytest

from _tiny import tiny_config, tiny_traffic
from harness import spec
from harness.driver import Loop, draw_weights, model_config
from harness.runner import Run, spans_of
from harness.traffic import ClosedLoop


def reader(name):
    return spec.reader(name)


def run_of(spans, t_open=1.0, t_close=2.0):
    return Run({}, None, 1.0, t_open, t_close, None, 0, spans)


def tick(n, start, wall_ms, device_ms):
    end = start + wall_ms * 1e-3
    dev = ("serve.tick.device", start + 1e-4, end - 1e-4, {"tick": n, "device_ms": device_ms})
    return [dev, ("serve.decode", start, end, {"tick": n, "uids": [0, 1]})]


def test_tick_split_adds_up_to_tick_ms():
    spans = (tick(0, 0.95, 20.0, 1.0)  # ends before the window opens: left out
             + tick(1, 1.10, 16.0, 12.5) + tick(2, 1.20, 14.0, 11.0) + tick(3, 1.30, 18.0, 12.0)
             + tick(4, 1.99, 20.0, 15.0))  # ends after it closes: left out
    run = run_of(spans)
    graph, host, wall = (reader(n)(run) for n in ("tick_graph_ms", "tick_host_ms", "tick_ms"))
    assert graph == pytest.approx((12.5 + 11.0 + 12.0) / 3)
    assert host == pytest.approx((3.5 + 3.0 + 6.0) / 3)
    assert graph + host == pytest.approx(wall)


def test_device_readers_give_nothing_without_device_time():
    """The parent's spans (no ``serve.tick.device``) and the CPU's (no
    ``device_ms``), or an untraced run: nothing, and no error."""
    bare = [("serve.decode", 1.1, 1.2, {"tick": 0, "uids": [0]}),
            ("serve.prefill", 1.3, 1.4, {"uid": 0, "rows": 9})]
    cpu = bare + [("serve.tick.device", 1.11, 1.19, {"tick": 0}),
                  ("serve.prefill.device", 1.3, 1.41, {"uid": 0, "rows": 9})]
    for spans in (bare, cpu, None):
        for name in ("tick_graph_ms", "tick_host_ms", "prefill_device_ms", "queue_wait_p90_ms"):
            assert reader(name)(run_of(spans)) is None


def test_prefill_device_ms_is_the_mean_of_the_windows_admissions():
    spans = [("serve.prefill.device", 0.5, 0.99, {"uid": 0, "rows": 9, "device_ms": 400.0}),
             ("serve.prefill.device", 1.1, 1.2, {"uid": 1, "rows": 9, "device_ms": 90.0}),
             ("serve.prefill.device", 1.3, 1.4, {"uid": 2, "rows": 12, "device_ms": 95.0}),
             ("serve.prefill", 1.3, 1.39, {"uid": 2, "rows": 12})]
    assert reader("prefill_device_ms")(run_of(spans)) == pytest.approx(92.5)


def test_queue_wait_p90_is_exact_over_the_waits_that_ended_in_the_window():
    rng = np.random.default_rng(3)
    waits = rng.exponential(0.05, 200)
    ends = rng.uniform(1.0, 2.0, 200)
    ends[:10] = 0.9  # ended before the window: left out
    spans = [("serve.queue_wait", e - w, e, {"uid": i})
             for i, (w, e) in enumerate(zip(waits, ends))]
    kept = [w for w, e in zip(waits, ends) if 1.0 < e <= 2.0]
    got = reader("queue_wait_p90_ms")(run_of(spans))
    assert got == pytest.approx(1e3 * np.percentile(kept, 90), rel=1e-9)


def test_engine_spans_on_the_cpu_reach_the_readers():
    """A tiny cell's engine on the CPU under a recording tracer: every
    admission's queue wait reaches ``queue_wait_p90_ms`` through
    ``spans_of``; the tick split and the prefill's device time need CUDA
    events and give nothing."""
    import torch

    from repro_torch import obs
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    conf, traffic = tiny_config(), tiny_traffic(3)
    cfg = model_config(conf)
    weights = draw_weights(cfg, 4, torch.device("cpu"))
    tracer = obs.Tracer()
    loop = Loop(lambda on_token: ContinuousBatchingEngine(
        cfg, weights, ContinuousConfig(**traffic["engine"]), device="cpu", seed=4,
        on_token=on_token, tracer=tracer), ClosedLoop(traffic, cfg.vocab_size, 4))
    loop.start()
    t_open = loop.clock() - 1.0
    for _ in range(12):
        loop.step()
    spans = spans_of(tracer)
    run = Run(conf["model"], None, 1.0, t_open, loop.clock(), loop, 0, spans)
    waits = [end - start for name, start, end, _ in spans if name == "serve.queue_wait"]
    assert len(waits) == loop.engine.metrics.counter("serve.requests.admitted").value()
    assert reader("queue_wait_p90_ms")(run) == pytest.approx(1e3 * np.percentile(waits, 90))
    ticks = [s for s in spans if s[0] == "serve.tick.device"]
    assert len(ticks) == loop.engine.ticks and all("device_ms" not in s[3] for s in ticks)
    for name in ("tick_graph_ms", "tick_host_ms", "prefill_device_ms"):
        assert reader(name)(run) is None
    assert reader("tick_ms")(run) is not None
