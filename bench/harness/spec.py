"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``), the plain reference and work
counts that file names under ``"reference"`` (``reference/<name>.py``, the
contract of :mod:`reference.common`), its traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``checks/<cell>.json``) and one reader per metric (``metrics/<metric>.py``,
a function ``read(run)``).  A later cell, metric or architecture is a new
file and a new entry; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_DIR.parent
BENCHMARK = REPO_ROOT / "BENCHMARK.json"
# what a configuration's reference module provides (reference.common)
REFERENCE_NAMES = ("logits", "prefill_flops", "decode_flops", "paged_least_s", "flash_least_s")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    arch: ModuleType  # the configuration's reference module
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_file(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def checks_file(cell: str) -> Path:
    return BENCH_DIR / "checks" / f"{cell}.json"


def reference_file(name: str) -> Path:
    return BENCH_DIR / "reference" / f"{name}.py"


def reference_module(name: str) -> ModuleType:
    """``reference.<name>``, the module a configuration names, with every
    name of the contract."""
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"a configuration's reference is a module name, got {name!r}")
    try:
        mod = importlib.import_module(f"reference.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"reference.{name}":
            raise
        raise FileNotFoundError(f"no reference module {name!r} at {reference_file(name)}") from None
    missing = [n for n in REFERENCE_NAMES if not callable(getattr(mod, n, None))]
    if missing:
        raise AttributeError(f"reference module {name!r} lacks {missing}")
    return mod


def metric_file(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(entries: List[dict], cell: str, per_layer: bool) -> List[Metric]:
    """The metrics a cell reports: those listing it under ``workloads``; an
    end-to-end metric with no such list is reported in every cell, and a
    per-layer metric has to have one."""
    out = []
    for m in entries:
        cells = m.get("workloads")
        if cells is None and per_layer:
            raise ValueError(f"per-layer metric {m['name']!r} lists no workloads")
        if cells is None or cell in cells:
            out.append(Metric(m["name"], m["unit"], reader(m["name"])))
    return out


def load_cell(name: str) -> Cell:
    bench = load_json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO_ROOT / configs[w["config"]]["file"])
    arch = reference_module(config.get("reference"))
    traffic = load_json(traffic_file(w["traffic"]))
    limits = load_json(checks_file(name))
    e2e = metrics_of(bench["end_to_end"], name, False)
    per_layer = metrics_of(bench["per_layer"], name, True)
    return Cell(name, int(w["chips"]), config, arch, traffic, limits, e2e, per_layer)


def all_files() -> Dict[str, Path]:
    """Every file ``BENCHMARK.json`` resolves to by name."""
    bench = load_json(BENCHMARK)
    files = {}
    for c in bench["configs"]:
        files[f"config {c['name']}"] = REPO_ROOT / c["file"]
        ref = load_json(REPO_ROOT / c["file"])["reference"]
        files[f"reference {ref}"] = reference_file(ref)
    for w in bench["workloads"]:
        files[f"traffic {w['traffic']}"] = traffic_file(w["traffic"])
        files[f"checks {w['name']}"] = checks_file(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        files[f"metric {m['name']}"] = metric_file(m["name"])
    return files
