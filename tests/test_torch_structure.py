"""Structure of the PyTorch port: it stands alone beside the JAX reference.

* importing ``repro_torch`` and every submodule loads neither ``jax`` nor
  anything of ``repro`` (checked in a fresh interpreter);
* no module of the port, nor ``chip_smoke.py``, imports them (AST scan);
* no module imports ``triton`` at module level: the port has no Triton
  body (``TRITON_BODY`` is None since the STAR softmax moved to CUDA), and
  ``chip_smoke.py`` may import it only inside a function, so the CPU can
  import every module;
* an entry point given no device runs on the card, and without CUDA it
  raises instead of carrying on on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
TRITON_BODY = None  # the port's kernels are all CUDA C++


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node


def test_import_loads_neither_jax_nor_the_reference():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT / 'src')!r})
import repro_torch
names = []
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name, _ in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_triton_only_in_its_body_module():
    """No Triton body is left, and nothing imports ``triton`` at module
    level (``chip_smoke.py`` may, inside a function, to find its tools)."""
    assert TRITON_BODY is None
    assert not list((PKG / "kernels").rglob("triton_kernel.py"))
    for path in _port_files():
        tree = ast.parse(path.read_text())
        top_level = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert not any(
            (a.name if isinstance(n, ast.Import) else (n.module or "")).startswith("triton")
            for n in top_level for a in n.names
        ), f"{path} imports triton at module level"


# the sources that quantize (grid snap, int8 codes, ADC): they round with rintf
QUANTIZING_SOURCES = ("flash_star.cu", "paged_attention.cu", "star_softmax_lut.cu",
                      "crossbar_matmul.cu")


def test_cuda_sources_build_for_sm90a_without_fast_math():
    from repro_torch.kernels import _cuda

    flags = " ".join(_cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    sources = sorted((PKG / "kernels").rglob("*.cu"))
    assert set(QUANTIZING_SOURCES) <= {src.name for src in sources}
    for src in sources:
        text = src.read_text()
        assert "roundf" not in text, src  # jnp.round is half to even: rintf
        if src.name in QUANTIZING_SOURCES:
            assert "rintf" in text, src
        assert "cudaGetLastError" in text, src


def test_build_keeps_the_compiler_log_beside_the_library(tmp_path, monkeypatch):
    """A library built once is reused with its nvcc / ptxas log read back
    from build/, so a later process (a test run, a second chip_smoke.py)
    still gets every source's log; a library without its log is rebuilt,
    and a failed compile leaves neither behind.  A stand-in compiler counts
    its calls."""
    from repro_torch.kernels import _cuda

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "echo x >> " + str(calls) + "\n"
        "while [ $# -gt 1 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=$2; fi; src=$2; shift\n"
        "done\n"
        "grep -q broken \"$src\" && { echo 'error: broken'; exit 1; }\n"
        "echo \"ptxas info    : Used 32 registers for $(basename $src)\"\n"
        ": > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(nvcc))
    src = tmp_path / "k.cu"
    src.write_text("__global__ void k() {}\n")
    n_calls = lambda: len(calls.read_text().splitlines()) if calls.exists() else 0

    first = _cuda.build([src])
    assert n_calls() == 1 and "Used 32 registers for k.cu" in first[src]
    assert _cuda.library_path(src).exists() and _cuda.log_path(src).exists()
    assert _cuda.build([src]) == first and n_calls() == 1
    _cuda.log_path(src).unlink()
    assert _cuda.build([src]) == first and n_calls() == 2

    bad = tmp_path / "bad.cu"
    bad.write_text("broken\n")
    with pytest.raises(RuntimeError, match="error: broken"):
        _cuda.build([src, bad])
    assert not _cuda.library_path(bad).exists() and not _cuda.log_path(bad).exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [_cuda.library_path(src).name, _cuda.log_path(src).name])


def test_entry_points_need_cuda_without_a_device(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models.param import materialize
    from repro_torch.models.registry import build_model
    from repro_torch.ops import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = get_smoke_config("granite_8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        materialize(build_model(cfg).param_specs(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg).init_paged_cache(4, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "granite_8b", "--smoke"])
    mamba = get_smoke_config("mamba2_130m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        materialize(build_model(mamba).param_specs(), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(mamba).init_cache(2)
    # prefill runs where its inputs live: CPU tensors are the caller's choice
    params = materialize(build_model(mamba).param_specs(), 0, "cpu")
    logits, cache = build_model(mamba).prefill(params, torch.zeros(1, 4, dtype=torch.int64), 8)
    assert logits.device.type == cache["layers"]["ssm"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "mamba2_130m", "--smoke", "--engine", "lockstep"])


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels import _cuda

    with pytest.raises(ValueError, match="CUDA or CPU"):
        _cuda.on_card(torch.zeros(1, device="meta"))
