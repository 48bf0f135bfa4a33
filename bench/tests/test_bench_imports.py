"""What the harness loads: after a whole run of a cell (at toy widths on the
CPU), no module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or the
JAX package's ``repro`` is loaded (names compared whole: ``repro_torch`` is
the port); the references load nothing of the port and of the harness only
its arithmetic (``harness.work``, which a reference re-exports as its
counts); and no code outside ``reference/`` names a reference module but
through a configuration."""

import ast
import subprocess
import sys

from _tiny import BENCH, ROOT

RUN = """
import sys, time
sys.path[:0] = [{tests!r}]
from _tiny import tiny_cell
import torch
from harness.runner import execute, loaded_forbidden
execute(tiny_cell(), 3, 0.2, False, torch.device("cpu"), time.perf_counter())
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print("FORBIDDEN", loaded_forbidden())
print("PORT", "repro_torch" in tops)
"""

REF = """
import sys
sys.path[:0] = [{bench!r}]
import reference.common, reference.model, reference.star, torch
tops = {{m.split(".")[0] for m in sys.modules}}
print("LOADED", sorted(tops & {{"repro_torch", "repro", "jax", "jaxlib", "flax"}}))
print("HARNESS", sorted(m for m in sys.modules if m.split(".")[0] == "harness"))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax_and_no_reference_package():
    out = _run(RUN.format(tests=str(BENCH / "tests")))
    assert "FORBIDDEN []" in out
    assert "PORT True" in out  # the check compares whole names: the port passes


def test_the_reference_loads_nothing_of_the_port():
    out = _run(REF.format(bench=str(BENCH)))
    assert "LOADED []" in out
    assert "HARNESS ['harness', 'harness.work']" in out


def test_no_source_under_bench_imports_jax_or_the_reference_package():
    for path in sorted(BENCH.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro"), f"{path}: {name}"
                if path.parent.name == "reference":
                    assert top != "repro_torch", f"{path}: {name}"
                    assert top != "harness" or name == "harness.work", f"{path}: {name}"


def test_only_a_configuration_names_a_reference_module():
    """The harness, the readers and the scripts reach a reference module
    through the configuration's ``"reference"`` key alone: they import only
    the shared :mod:`reference.common` and :mod:`reference.star`, and name
    no other."""
    shared = ("reference.common", "reference.star")
    for path in sorted(BENCH.rglob("*.py")):
        if path.parent.name in ("reference", "tests"):
            continue
        text = path.read_text()
        assert "reference.model" not in text, path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = ([f"{node.module}.{a.name}" for a in node.names]
                         if node.module == "reference" else [node.module])
            else:
                continue
            for name in names:
                assert name.split(".")[0] != "reference" or name in shared, f"{path}: {name}"
