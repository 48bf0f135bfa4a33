"""Build and bind the CUDA C++ kernels: ``nvcc`` -> shared library -> ctypes.

Each ``csrc/*.cu`` exposes a plain C entry point that launches its kernel on
the stream it is given and returns ``cudaGetLastError()``.  Libraries are
built at first use from the sources in the checkout into ``build/`` at the
repository root, named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is reused.  Each library's nvcc /
ptxas log is kept beside it (``.log``), so a later process that reuses
the library still reads what the compiler made of it.  ``build`` starts
one ``nvcc`` per source, all at once.

Launch counters survive CUDA graphs: while a graph is captured its
launches tally into the graph (``launches_into``), not into the global
counts, and each replay adds the graph's tally (``add_launches``), so
``launch_counts()`` counts device launches either way.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Iterator, List

import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class LaunchCounter:
    """A plain count of kernel launches, bumped by a wrapper where it
    launches its kernel and nowhere else.  Inside ``launches_into(tally)``
    the launch goes to ``tally`` instead: a kernel recorded into a graph
    being captured has not run yet."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        if _TALLIES:
            tally = _TALLIES[-1]
            tally[self.name] = tally.get(self.name, 0) + 1
        else:
            self.count += 1

    def reset(self) -> None:
        self.count = 0


_COUNTERS: Dict[str, LaunchCounter] = {}
_TALLIES: List[Dict[str, int]] = []


@contextlib.contextmanager
def launches_into(tally: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Count the block's launches into ``tally`` (innermost block wins)
    instead of the global counts."""
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.pop()


def add_launches(tally: Dict[str, int]) -> None:
    """Add a tally to the counts: a replayed graph's launches ran now."""
    for name, n in tally.items():
        launch_counter(name).count += n


def launch_counter(name: str) -> LaunchCounter:
    if name not in _COUNTERS:
        _COUNTERS[name] = LaunchCounter(name)
    return _COUNTERS[name]


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in sorted(_COUNTERS.items())}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.reset()


class KernelGradError(RuntimeError):
    """A kernel wrapper was called where autograd would differentiate it.
    The kernels have no backward: on the card a launch returns an output
    with no autograd history, so a wrapper refuses (on the CPU too, where
    its plain version would have trained) rather than drop the gradient."""


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise :class:`KernelGradError` when grad mode is on and any tensor
    among ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise KernelGradError(
            f"{kernel} has no backward: call it under torch.no_grad(), or train through "
            f"a plain impl (attention 'xla' / 'reference', softmax 'reference', ssd_scan "
            f"'reference', matmul 'xla')")


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device is refused, and so is a fake
    tensor (``FakeTensorMode``: a shape with no data to launch on)."""
    if t.device.type == "cuda":
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(t, FakeTensor):
            raise ValueError("kernels take real tensors: a fake tensor holds no data to "
                             "launch on (trace a plain impl)")
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"kernels take CUDA or CPU tensors, got device {t.device}")


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def log_path(source: Path) -> Path:
    """The nvcc / ptxas log kept beside ``library_path(source)``."""
    return library_path(source).with_suffix(".log")


def build(sources: Iterable[Path]) -> Dict[Path, str]:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together.  Returns ``{source: nvcc/ptxas log}`` for every source given,
    read back from ``build/`` for one built earlier; raises on a failure.
    A library counts as built once both it and its log are there."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [Path(src) for src in sources]
    procs: List[tuple] = []
    for src in sources:
        out = library_path(src)
        if out.exists() and log_path(src).exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        log_tmp = log_path(src).with_suffix(f".{os.getpid()}.logtmp")
        log_tmp.write_text(log)
        os.replace(log_tmp, log_path(src))
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return {src: log_path(src).read_text() for src in sources}


_LIBS: Dict[Path, ctypes.CDLL] = {}


def load(source: Path, bind) -> ctypes.CDLL:
    """The built library of ``source`` (built now if missing), with
    ``bind(lib)`` run once to declare argtypes/restype."""
    source = Path(source)
    if source not in _LIBS:
        path = library_path(source)
        build([source])
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        bind(lib)
        _LIBS[source] = lib
    return _LIBS[source]


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")

