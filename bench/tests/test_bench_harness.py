"""The harness on the CPU with a fake engine and a fake clock: the closed loop
and its residual first wave, the exact percentiles, a stall moving the
end-to-end metrics, the work counts against hand counts, and every entry of
``BENCHMARK.json`` resolving to its files by name."""

import json
import subprocess
import sys

import numpy as np
import pytest

from _tiny import BENCH, ROOT, tiny_traffic
from harness import spec, work
from harness.driver import Loop
from harness.profiling import idle_by_host, kernel_group
from harness.runner import Run
from harness.traffic import ClosedLoop, log_uniform_quantiles


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Ev:
    def __init__(self, uid, token, index, finished):
        self.uid, self.token, self.index, self.finished = uid, token, index, finished


class FakeEngine:
    """Admits every pending request at the next step (a prefill that costs
    ``prefill_s``), then gives every active request one token a step
    (``tick_s``); the step numbered ``stall_at`` first stalls ``stall_s``."""

    def __init__(self, on_token, clock, tick_s=0.01, prefill_s=0.05):
        self.on_token, self.clock = on_token, clock
        self.tick_s, self.prefill_s = tick_s, prefill_s
        self.pending, self.active, self.uid = [], {}, 0
        self.stall_at, self.stall_s = None, 0.0
        self.steps = 0

    def submit(self, prompt, max_new_tokens):
        self.pending.append((self.uid, max_new_tokens))
        self.uid += 1
        return self.uid - 1

    def _emit(self, uid):
        n_left, idx = self.active[uid]
        done = n_left == 1
        self.on_token(Ev(uid, 7, idx, done))
        if done:
            del self.active[uid]
        else:
            self.active[uid] = (n_left - 1, idx + 1)

    def step(self):
        if self.steps == self.stall_at:  # the host stalls before this step's work
            self.clock.t += self.stall_s
        self.steps += 1
        for uid, n in self.pending:
            self.clock.t += self.prefill_s
            self.active[uid] = (n, 0)
            self._emit(uid)
        self.pending = []
        self.clock.t += self.tick_s
        for uid in sorted(self.active):
            self._emit(uid)


def make_loop(clients=4, seed=5, clock=None, **kw):
    clock = clock or FakeClock()
    traffic = tiny_traffic(clients)
    gen = ClosedLoop(traffic, 300, seed)
    loop = Loop(lambda on_token: FakeEngine(on_token, clock, **kw), gen, clock=clock)
    return loop, clock


def test_closed_loop_keeps_every_client_busy():
    loop, clock = make_loop()
    loop.start()
    for _ in range(200):
        loop.step()
        live = [r for r in loop.requests.values() if r.finish_t is None]
        assert len(live) == 4  # a finished client submits again before the next step
    by_client = {}
    for r in loop.requests.values():
        by_client.setdefault(r.client, []).append(r)
    for reqs in by_client.values():  # one at a time per client, each after the last ended
        for a, b in zip(reqs, reqs[1:]):
            assert a.finish_t is not None and b.submit_t >= a.finish_t
    for r in loop.requests.values():
        if r.finish_t is not None:
            assert len(r.tokens) == r.max_new_tokens


def test_residual_first_wave_and_same_sizes_for_every_seed():
    traffic = tiny_traffic(4)
    a, b = ClosedLoop(traffic, 300, 1), ClosedLoop(traffic, 300, 2 ** 31 + 11)
    assert sorted(a.prompt_lens) == sorted(b.prompt_lens)
    assert sorted(a.output_lens) == sorted(b.output_lens)
    assert list(a.prompt_lens) != list(b.prompt_lens)
    lo, hi = traffic["output_len"]
    first = a.first_wave()
    for c, r in enumerate(first):
        drawn = int(a.output_lens[c])
        assert 1 <= r.max_new_tokens <= drawn <= hi
        assert r.max_new_tokens == max(1, int(np.ceil(drawn * a.residual[c])))
    assert sorted(a.residual) == pytest.approx([(i + 0.5) / 4 for i in range(4)])
    later = a.next_for(0)
    assert lo <= later.max_new_tokens <= hi
    again = ClosedLoop(traffic, 300, 1)
    assert [r.prompt.tolist() for r in again.first_wave()] == [r.prompt.tolist() for r in first]


def test_log_uniform_quantiles():
    q = log_uniform_quantiles(16, 96, 1000)
    assert q.min() >= 16 and q.max() <= 96
    assert abs(np.median(q) - np.sqrt(16 * 96)) <= 1


def window_run(loop, t_open, t_close, peak=0):
    return Run({}, None, 1.0, t_open, t_close, loop, peak)


def reader(name):
    return spec.reader(name)


def test_exact_percentiles_and_rate():
    loop, clock = make_loop(clients=2, tick_s=0.01, prefill_s=0.0)
    loop.start()
    loop.step()
    t_open = clock.t
    for _ in range(100):
        loop.step()
    run = window_run(loop, t_open, clock.t)
    gaps = [b - a for r in loop.requests.values() for a, b in zip(r.times, r.times[1:])
            if t_open < b <= clock.t]
    assert reader("itl_p95_ms")(run) == pytest.approx(1e3 * np.percentile(gaps, 95))
    # 2 clients, one token each a step of 10 ms (a new request's first token
    # and its tick token come in the same step)
    assert reader("output_tok_s")(run) >= 2 / 0.01


def test_a_stall_moves_rate_and_tails():
    def measure(stall_s):
        loop, clock = make_loop(clients=4, tick_s=0.01, prefill_s=0.02)
        loop.engine.stall_at, loop.engine.stall_s = None, 0.0
        loop.start()
        loop.step()
        t_open = clock.t
        for i in range(300):
            if stall_s and i % 10 == 0:
                loop.engine.stall_at, loop.engine.stall_s = loop.engine.steps, stall_s
            loop.step()
        run = window_run(loop, t_open, clock.t)
        return {n: reader(n)(run) for n in ("output_tok_s", "itl_p95_ms", "ttft_p90_ms")}

    base, stalled = measure(0.0), measure(0.2)
    assert stalled["output_tok_s"] < 0.75 * base["output_tok_s"]
    assert stalled["itl_p95_ms"] > 3 * base["itl_p95_ms"]
    assert stalled["ttft_p90_ms"] > base["ttft_p90_ms"]


def test_ttft_counts_requests_still_waiting():
    loop, clock = make_loop(clients=1, tick_s=0.01, prefill_s=0.0)
    loop.start()
    # nothing stepped: the first request waits from its submit to the close
    clock.t = 2.0
    run = window_run(loop, -1.0, 2.0)
    assert reader("ttft_p90_ms")(run) == pytest.approx(2000.0)


GRANITE = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2, "d_ff": 16,
           "vocab_size": 10}


def test_counts_against_hand_counts():
    m = GRANITE
    hd = 2
    per_layer = 8 * hd * (4 + 4 + 2 + 2) + 3 * 8 * 16
    assert work.layer_params(m) == per_layer
    # decode: 2 x params + 4 * Hq * D per attended row per layer
    assert work.decode_flops(m, 5) == 2 * (2 * per_layer + 8 * 10) + 2 * 4 * 4 * hd * 5
    # prefill of 3: every row, the last row's logits, causal rows 1 + 2 + 3
    assert work.prefill_flops(m, 3) == 2 * 2 * per_layer * 3 + 2 * 8 * 10 + 2 * 4 * 4 * hd * 6
    moe = dict(m, num_experts=4, top_k=2)
    assert work.layer_params(moe) == 8 * hd * 12 + 8 * 4 + 2 * 3 * 8 * 16
    # paged: K and V of each live row, q and out of each request, bf16, all layers
    assert work.paged_bytes(m, [3, 5]) == 2 * (2 * 8 * 2 * hd * 2 + 2 * 2 * 4 * hd * 2)
    assert work.paged_least_s(m, [3, 5]) == work.paged_bytes(m, [3, 5]) / work.HBM_BW
    # flash: a long prompt is bound by its FLOPs, a short one by its bytes
    big = dict(num_layers=1, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=1, vocab_size=1)
    t = 4096
    assert work.flash_least_s(big, t) == pytest.approx(
        4 * 32 * 128 * t * (t + 1) // 2 / work.PEAK_FLOPS)
    assert work.flash_least_s(m, 3) == pytest.approx(
        2 * 3 * hd * (2 * 4 + 2 * 2) * 2 / work.HBM_BW)


def test_idle_gaps_and_groups():
    host = sorted([(0, 100, "step"), (10, 20, "a"), (30, 60, "b"), (40, 50, "c")])
    gaps = dict(idle_by_host([(0, 5), (25, 28), (55, 58), (90, 95)], 0, 100, host))
    assert gaps == pytest.approx({"a": 20e-6, "c": 27e-6, "step": 37e-6})
    assert kernel_group("void paged_split_kernel<...>") == "paged_attention"
    assert kernel_group("flash_star_mma_kernel<128, true>") == "flash_star"
    assert kernel_group("sm90_xmma_gemm_bf16bf16") == "gemm"
    assert kernel_group("Memcpy DtoH (Device -> Pinned)") == "copy/cast"
    assert kernel_group("vectorized_elementwise_kernel<mul>") == "other"


def test_every_entry_resolves_by_name():
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    for label, path in spec.all_files().items():
        assert path.is_file(), f"{label}: {path} is missing"
        assert str(path.resolve()).startswith(str(BENCH)), f"{label} lies outside bench/"
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:  # every moved metric is reported in the cell
            entry = next(e for e in bench["per_layer"] if e["name"] == m.name)
            assert entry["moves"] in names
        assert {"widest_gap", "bad_answers"} < set(cell.limits)  # and a number the control fails
        import torch

        from harness import check

        assert set(check.readings(torch.zeros(3), 0, cell.limits)) == set(cell.limits)
        conf = cell.config
        assert conf["name"] == w["config"] and conf["model"]["name"] == w["config"]
        t = cell.traffic
        assert t["engine"]["num_slots"] >= t["clients"]  # full capacity: nobody queues
        assert t["prompt_len"][1] + t["output_len"][1] - 1 <= t["engine"]["max_len"]
    for c in bench["configs"]:
        conf = spec.load_json(ROOT / c["file"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]


def test_readings_named_by_the_limits():
    import torch

    from harness import check

    gaps = torch.tensor([0.0, 0.0, 0.1, 0.3, 0.6], dtype=torch.float64)
    limits = {"mean_gap": {"limit": 0.1}, "widest_gap": {"limit": 1.0},
              "far_share": {"over": 0.25, "limit": 0.3}, "bad_answers": {"limit": 0}}
    values = check.readings(gaps, 0, limits)
    assert values == pytest.approx({"mean_gap": 0.2, "widest_gap": 0.6, "far_share": 0.4,
                                    "bad_answers": 0})
    rows = check.judge(values, limits)
    assert [r["ok"] for r in rows] == [False, True, False, True]
    assert not check.correct(rows)
    assert check.correct(check.judge(check.readings(gaps / 10, 0, limits), limits))
    # no sample: nothing to judge the gaps by, not correct
    assert not check.correct(check.judge(check.readings(None, 0, limits), limits))
    with pytest.raises(ValueError):
        check.readings(gaps, 0, {"median_gap": {"limit": 1.0}})


def test_per_layer_metrics_list_their_cells():
    with pytest.raises(ValueError):
        spec.metrics_of([{"name": "mfu", "unit": "%"}], "granite8b.decode", True)
    e2e = spec.metrics_of([{"name": "setup_s", "unit": "s"}], "granite8b.decode", False)
    assert [m.name for m in e2e] == ["setup_s"]


def test_run_refuses_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line; and likewise in a checkout
    that holds only BENCHMARK.json and bench/."""
    args = ["--workload", "granite8b.decode", "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", *args], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((ROOT / "BENCHMARK.json").read_text())["command"] == [
        "python3", "bench/run.py"]
