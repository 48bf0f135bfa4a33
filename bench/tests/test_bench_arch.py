"""A configuration names its plain reference and work counts: a module of
``bench/reference/`` under ``"reference"``.  The shipped configurations name
``reference.model``, whose counts are the yardstick's as they stood before
the key existed; a module that is missing, or lacks a name of the contract,
fails in ``load_cell``; and a configuration with an architecture of its own
is added as new files only: a stand-in module, its configuration, traffic
and limits, and entries in ``BENCHMARK.json``, run end to end on the CPU
through the stand-in's ``logits`` (the reference and the float8 control) and
the four readers through its counts."""

import dataclasses
import json
import shutil
import sys
import time
import types

import pytest
import torch

from _tiny import BENCH, ROOT, tiny_config, tiny_traffic
from harness import spec, work
from harness.profiling import Profile
from harness.runner import execute
from reference import common
from reference import model as ref_model

PROMPTS = [1, 17, 256, 1024, 2500, 3968]
ROWS = [1, 300, 1025, 4095]
PAGED = [[1], [256, 1024, 3000], [4096] * 32, list(range(129, 4096, 61))]
GRID = {"prefill_flops": PROMPTS, "decode_flops": ROWS, "paged_least_s": PAGED,
        "flash_least_s": PROMPTS}
# harness.work's counts of the shipped configurations on GRID, before any
# configuration named its reference
BEFORE = {
    "granite-8b": {
        "prefill_flops": [16106717184, 267451957248, 4039894892544, 16390299844608,
                          41103025373184, 66956354912256],
        "decode_flops": [16106717184, 16283074560, 16710696960, 18521456640],
        "paged_least_s": [2.2008358208955223e-07, 0.00018891974686567164, 0.00577499319402985,
                          0.00614574599641791],
        "flash_least_s": [2.2008358208955223e-07, 3.741420895522388e-06, 5.634139701492537e-05,
                          0.0003129824420626896, 0.0018644461880687564, 0.004696225205969667],
    },
    "granite-moe-1b-a400m": {
        "prefill_flops": [857315328, 12977018880, 197010659328, 826395334656, 2198792509440,
                          3776175937536],
        "decode_flops": [857315328, 886708224, 957978624, 1259771904],
        "paged_least_s": [4.401671641791045e-08, 6.288521552238805e-05, 0.0019240587080597016,
                          0.002046645263283582],
        "flash_least_s": [4.401671641791045e-08, 7.482841791044776e-07, 1.1268279402985075e-05,
                          5.2163740343781596e-05, 0.0003107410313447927, 0.0007827042009949444],
    },
}
COUNTS = tuple(GRID)


def _bench():
    return spec.load_json(ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("config", sorted(BEFORE))
@pytest.mark.parametrize("count", COUNTS)
def test_shipped_configurations_count_as_before(config, count):
    """Both configurations resolve to ``reference.model``, whose counts equal
    the yardstick's values from before, exactly."""
    entry = next(c for c in _bench()["configs"] if c["name"] == config)
    conf = spec.load_json(ROOT / entry["file"])
    assert conf["reference"] == "model"
    arch = spec.reference_module(conf["reference"])
    assert arch is ref_model
    assert getattr(arch, count) is getattr(work, count)  # re-exported, not copied
    got = [getattr(arch, count)(conf["model"], x) for x in GRID[count]]
    assert got == BEFORE[config][count]
    assert [type(v) for v in got] == [type(v) for v in BEFORE[config][count]]


def test_every_cell_loads_the_module_its_configuration_names():
    bench = _bench()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        named = spec.load_json(ROOT / files[w["config"]])["reference"]
        assert cell.arch is sys.modules[f"reference.{named}"]
    assert spec.all_files()["reference model"] == BENCH / "reference" / "model.py"


def _checkout(tmp_path, monkeypatch, config: dict, cell: str = "standin.decode"):
    """A copy of ``BENCHMARK.json`` and ``bench/`` with one configuration and
    one cell added as new files and entries, made the harness's own."""
    bench_dir = tmp_path / "bench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "configs" / "standin-tiny.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "standin_tiny.json").write_text(json.dumps(tiny_traffic(3)))
    (bench_dir / "checks" / f"{cell}.json").write_text(json.dumps(
        {"mean_gap": {"limit": 0.25}, "widest_gap": {"limit": 0.25},
         "bad_answers": {"limit": 0}}))
    bench = _bench()
    bench["configs"].append({"name": "standin-tiny", "source": "https://example.org/standin",
                             "file": "bench/configs/standin-tiny.json", "reduced": [],
                             "why": "a stand-in architecture"})
    bench["workloads"].append({"name": cell, "config": "standin-tiny",
                               "traffic": "standin_tiny", "chips": 1, "why": "a stand-in cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "granite8b.prefill" in m["workloads"]:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    monkeypatch.setattr(spec, "REPO_ROOT", tmp_path)
    monkeypatch.setattr(spec, "BENCHMARK", tmp_path / "BENCHMARK.json")


def _standin(calls: list, counts: bool = True) -> types.ModuleType:
    """A reference module of its own: ``reference.model``'s logits, and counts
    three times ``reference.model``'s, each call recorded."""
    mod = types.ModuleType("reference.standin")

    def logits(weights, model, fmt, tokens, prompt_len, out_rows, prec=common.FLOAT32,
               q_block=256):
        calls.append(("logits", prec.name))
        return ref_model.logits(weights, model, fmt, tokens, prompt_len, out_rows, prec, q_block)

    def tripled(name):
        def count(model, x):
            calls.append((name, x))
            return 3 * getattr(ref_model, name)(model, x)
        return count

    mod.logits = logits
    if counts:
        for name in COUNTS:
            setattr(mod, name, tripled(name))
    return mod


@pytest.mark.parametrize("reference, error", [
    ("no_such_arch", FileNotFoundError),
    (None, ValueError),
    ("model.py", ValueError),
    ("standin", AttributeError),  # logits, but no counts
])
def test_a_missing_reference_fails_in_load_cell(tmp_path, monkeypatch, reference, error):
    conf = tiny_config()
    if reference is None:
        del conf["reference"]
    else:
        conf["reference"] = reference
    _checkout(tmp_path, monkeypatch, conf)
    monkeypatch.setitem(sys.modules, "reference.standin", _standin([], counts=False))
    if reference == "no_such_arch":
        assert spec.all_files()["reference no_such_arch"] == \
            tmp_path / "bench" / "reference" / "no_such_arch.py"
    with pytest.raises(error, match="reference"):
        spec.load_cell("standin.decode")


def test_a_new_architecture_is_new_files_only(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "reference.standin", _standin(calls))
    conf = dict(tiny_config(), reference="standin")
    _checkout(tmp_path, monkeypatch, conf)
    for label, path in spec.all_files().items():
        assert path.is_file() or label == "reference standin", label
    cell = spec.load_cell("standin.decode")
    assert cell.arch is sys.modules["reference.standin"]

    line, _, gaps, run = execute(cell, 5, 0.5, False, torch.device("cpu"), time.perf_counter(),
                                 control=True)
    assert line["correct"], line["checks"]
    assert gaps["control"] is not None
    precs = {p for name, p in calls if name == "logits"}
    assert precs == {common.FLOAT32.name, common.FLOAT8.name}  # reference and control
    assert run.arch is cell.arch

    # the four readers on the run's own steps, with spans and a profile
    # laid over them
    m, steps = run.model, run.loop.steps
    uids = [u for u, r in run.loop.requests.items() if r.tokens]
    spans = [("serve.prefill", run.t_open + 0.01 * i, run.t_open + 0.01 * (i + 1), {"uid": u})
             for i, u in enumerate(uids)]
    prof = Profile(1.0, 1.0, {}, {"paged_attention": 0.5, "flash_star": 0.25}, {}, [], 0,
                   len(steps))
    run = dataclasses.replace(run, spans=spans, profile=prof, t_close=run.t_open + 1.0)
    del calls[:]
    read = {n: spec.reader(n)(run) for n in ("mfu", "mfu.prefill", "paged_attention_roofline",
                                             "flash_star_roofline")}
    assert {name for name, _ in calls} == set(COUNTS)
    window = [s for s in steps if s.t0 >= run.t_open and s.t1 <= run.t_close]
    flops = sum(sum(3 * ref_model.prefill_flops(m, t) for t in s.prefills)
                + sum(3 * ref_model.decode_flops(m, r) for r in s.tick_rows) for s in window)
    prefill = sum(3 * ref_model.prefill_flops(m, run.loop.requests[u].prompt_len) for u in uids)
    paged = sum(3 * ref_model.paged_least_s(m, s.tick_rows) for s in steps if s.tick_rows)
    flash = sum(3 * ref_model.flash_least_s(m, t) for s in steps for t in s.prefills)
    seconds = sum(end - start for _, start, end, _ in spans)
    assert flops > 0 and paged > 0 and flash > 0
    assert read == pytest.approx({
        "mfu": 100.0 * flops / run.window_s / work.PEAK_FLOPS,
        "mfu.prefill": 100.0 * prefill / seconds / work.PEAK_FLOPS,
        "paged_attention_roofline": 100.0 * paged / 0.5,
        "flash_star_roofline": 100.0 * flash / 0.25}, rel=1e-12)
