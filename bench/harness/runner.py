"""One run of one cell: set-up, the measured window, the traced run's
profile, the comparison with the reference, and the result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up is everything before the window opens: importing the program,
drawing the weights, building the engine, admitting the first wave of
requests (every client at once) and ``warmup_steps`` more steps, which
capture the decode tick's CUDA graph.  The window then runs the closed loop
for ``--seconds`` and closes at the end of the first step past it.  A traced
run (``--trace 1``) also records the engine's spans over the window and
then profiles ``profile_steps`` further steps.  Nothing of the reference
runs before the program's state is freed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from types import ModuleType
from typing import List, Optional

from harness import check as check_lib
from harness import profiling
from harness.driver import Loop, draw_weights, model_config
from harness.spec import Cell, load_cell
from harness.traffic import ClosedLoop

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names the run may not load
TRACE_CAPACITY = 1 << 21


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    model: dict
    arch: ModuleType  # the configuration's reference module: its work counts
    setup_s: float
    t_open: float
    t_close: float
    loop: Loop
    peak_bytes: int
    spans: Optional[List[tuple]] = None  # (name, start, end, args) on the host clock
    profile: Optional[profiling.Profile] = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open < t <= self.t_close

    def window_steps(self) -> list:
        return [s for s in self.loop.steps if s.t0 >= self.t_open and s.t1 <= self.t_close]

    def window_spans(self, name: str) -> list:
        return [s for s in self.spans or () if s[0] == name and self.in_window(s[2])]


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def spans_of(tracer) -> List[tuple]:
    """The tracer's complete spans and begin/end pairs as (name, start, end,
    args) on the host clock."""
    out, open_ = [], {}
    epoch = tracer._epoch
    for ev in tracer.events:
        t = epoch + ev.ts * 1e-6
        if ev.ph == "X":
            out.append((ev.name, t, t + ev.dur * 1e-6, ev.args or {}))
        elif ev.ph == "B":
            open_[ev.name] = (t, ev.args or {})
        elif ev.ph == "E" and ev.name in open_:
            t0, args = open_.pop(ev.name)
            out.append((ev.name, t0, t, args))
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            control: bool = False):
    """Run the cell; returns ``(result line, check rows, the sample's gaps
    (with the control's and the altered token's when ``control``; None
    without a sample), the run's record)``."""
    import torch

    from repro_torch import obs
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    conf, traffic = cell.config, cell.traffic
    marks = [("start", t_start), ("imports", time.perf_counter())]
    cfg = model_config(conf)
    weights = draw_weights(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(("weights", time.perf_counter()))
    engine_seed = int(seed) % (1 << 32)
    tracer = obs.enable_tracing(capacity=TRACE_CAPACITY) if trace else None
    cb = ContinuousConfig(**traffic["engine"])
    gen = ClosedLoop(traffic, cfg.vocab_size, seed)
    loop = Loop(lambda on_token: ContinuousBatchingEngine(
        cfg, weights, cb, device=device, seed=engine_seed, on_token=on_token), gen)
    marks.append(("engine", time.perf_counter()))
    try:
        loop.start()
        loop.step()
        marks.append(("first wave", time.perf_counter()))
        for _ in range(int(traffic["warmup_steps"])):
            loop.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_open = time.perf_counter()
        marks.append(("warm-up", t_open))
        setup_s = t_open - t_start
        t_close = loop.run_until(t_open + seconds)
        steps = sum(1 for s in loop.steps if s.t0 >= t_open)
        print("set-up (s): " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in
                                        zip(marks, marks[1:]))
              + f"; window {t_close - t_open:.3f} s, {steps} steps", file=sys.stderr)
        spans = spans_of(tracer) if trace else None
        prof, retaken = None, []
        if trace:
            prof, retaken = profiling.profile_steps(loop.step, int(traffic["profile_steps"]),
                                                    lambda: len(loop.steps))
            if prof is None:
                print(f"profiler: every window fell short ({retaken}): the device's "
                      "shares are not measured", file=sys.stderr)
            else:
                print(f"profile: {traffic['profile_steps']} steps, window {prof.window_s:.4f} s, "
                      f"busy {prof.busy_s:.4f} s; device s by group "
                      f"{ {g: round(v, 4) for g, v in sorted(prof.groups.items())} }; "
                      f"launches {prof.launches}; windows taken again {retaken}",
                      file=sys.stderr)
    finally:
        if trace:
            obs.disable_tracing()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(conf["model"], cell.arch, setup_s, t_open, t_close, loop, peak, spans, prof)

    # the program's state goes before the reference runs
    loop.engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    done = check_lib.finished_in(loop.requests, t_open, t_close)
    picked = check_lib.sample(done, seed, int(traffic["check_tokens"]),
                              int(traffic["check_requests"]))
    bad = check_lib.bad_answers(done, cfg.vocab_size)
    gaps = None
    if picked:
        gaps = check_lib.token_gaps(picked, weights, conf, cell.arch, cb.temperature,
                                    engine_seed, device, control=control)
        print("gaps: " + ", ".join(f"{k} {check_lib.summary(g)}" for k, g in gaps.items()
                                   if g is not None), file=sys.stderr)
    rows = check_lib.judge(check_lib.readings(gaps["served"] if gaps else None, bad, cell.limits),
                           cell.limits)
    print(f"check: {len(picked)} of {len(done)} requests finished in the window, "
          f"{sum(len(r.tokens) for r in picked)} tokens, {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
    attempted = sum(1 for r in loop.requests.values() if run.in_window(r.submit_t))
    refused = sum(1 for t in loop.refused if run.in_window(t))
    line = {"correct": check_lib.correct(rows),
            "attempted": attempted + refused, "failed": refused,
            "metrics": metrics, "device": dev}
    if prof is not None:
        line["breakdown"] = profiling.breakdown(prof)
    line["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return line, rows, gaps, run


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no run",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line, rows, _, _ = execute(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    found = loaded_forbidden()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for r in rows:
        print(f"check {r['name']}: {r['value']} (limit {r['limit']}) "
              f"{'ok' if r['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
