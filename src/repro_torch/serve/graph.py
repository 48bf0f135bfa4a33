"""CUDA graphs of the serving engines' decode steps: the port's counterpart
of the reference's ``jax.jit`` around a tick (DESIGN.md §11).

A :class:`StepGraphs` keeps one captured graph per key.  The key holds
everything a capture resolved: the caller's part (slot count, table width,
pool dtype, greedy or sampled, the spec impls) and the ``ops.use``
overrides active at the call (``registry.active_impls()``).  A step under
another route captures a graph of its own and never replays a stale one;
``entries()`` counts the captures, the counterpart of the reference's
``jit_cache_entries``.

Capture goes PyTorch's documented way.  The step runs once eagerly on a
side stream first (``warmup``: the caller runs it on copies of its state,
so nothing advances), which loads the kernel libraries, makes cuBLAS's
handle and workspace for that stream and fills the LUT and fault-table
caches.  Then ``torch.cuda.graph`` records the step on the same stream into
a private memory pool.  Inputs and outputs are static: the caller writes
its inputs in place before ``run`` and reads the tensors it returns.

Launch counters: the recording's launches tally into the graph
(``_cuda.launches_into``) and each replay adds that tally to the global
counts, so ``launch_counts()`` counts device launches either way; the
warm-up's launches go to ``warmup_launches`` (they ran, as set-up, and are
reported apart).

On a CPU device there is no graph: the step runs eagerly at every ``run``
(:class:`EagerGraph`), chosen by the device as a kernel wrapper picks its
plain version.  A failed capture raises :class:`GraphCaptureError` naming
the key; it is never retried eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels import _cuda
from repro_torch.ops import registry


class GraphCaptureError(RuntimeError):
    """Capturing a step into a CUDA graph failed (the message names the
    route: the graph's key)."""


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` of a step, warmed up and captured on
    ``stream``."""

    def __init__(self, device: torch.device, stream):
        self._graph = torch.cuda.CUDAGraph()
        self._stream = stream
        self._device = device
        self._outputs = None

    def warmup(self, fn: Callable[[], Any]) -> None:
        current = torch.cuda.current_stream(self._device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            fn()
        current.wait_stream(self._stream)

    def capture(self, fn: Callable[[], Any]) -> None:
        with torch.cuda.graph(self._graph, stream=self._stream):
            self._outputs = fn()

    def replay(self):
        self._graph.replay()
        return self._outputs


class EagerGraph:
    """The CPU's stand-in for a graph: nothing is captured, the step runs
    at every replay."""

    def __init__(self, device: torch.device, stream=None):
        self._fn: Optional[Callable[[], Any]] = None

    def warmup(self, fn: Callable[[], Any]) -> None:
        pass

    def capture(self, fn: Callable[[], Any]) -> None:
        self._fn = fn

    def replay(self):
        return self._fn()


@dataclasses.dataclass
class _Entry:
    graph: Any
    launches: Dict[str, int]  # recorded at capture, added at each replay
    warmup_launches: Dict[str, int]


class StepGraphs:
    """Captured graphs of one step function, keyed by what capture
    resolved.  ``graph_factory(device, stream)`` makes a graph object
    (``warmup``, ``capture``, ``replay``); the default is
    :class:`CudaGraph` on a CUDA device and :class:`EagerGraph` on the CPU
    (tests pass a stand-in)."""

    def __init__(self, device: torch.device, graph_factory=None):
        self.device = torch.device(device)
        on_card = self.device.type == "cuda"
        if graph_factory is None:
            graph_factory = CudaGraph if on_card else EagerGraph
        self._new_graph = graph_factory
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        self._entries: Dict[Hashable, _Entry] = {}
        self.replays = 0
        self.capture_seconds = 0.0  # host time of warm-ups and captures, queued work excluded

    def entries(self) -> int:
        """Graphs captured: one per key seen (none is ever dropped)."""
        return len(self._entries)

    def run(self, route: Hashable, fn: Callable[[], Any],
            warmup: Callable[[], Any]) -> Any:
        """Replay the graph of ``route`` under the active overrides,
        capturing it first (``warmup()`` eagerly, then ``fn()`` recorded)
        when there is none.  Returns ``fn``'s outputs as the replay left
        them."""
        key = (route, registry.active_impls())
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(key, fn, warmup)
        out = entry.graph.replay()
        _cuda.add_launches(entry.launches)
        self.replays += 1
        return out

    def warmup_launches(self) -> Dict[str, int]:
        """Launches the warm-ups made, summed over every capture."""
        total: Dict[str, int] = {}
        for entry in self._entries.values():
            for name, n in entry.warmup_launches.items():
                total[name] = total.get(name, 0) + n
        return total

    def _capture(self, key: Hashable, fn, warmup) -> _Entry:
        if self.device.type == "cuda":
            # finish the work queued before it, so that ``capture_seconds``
            # holds only the capture's own (``torch.cuda.graph`` would wait too)
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        graph = self._new_graph(self.device, self._stream)
        entry = _Entry(graph, {}, {})
        with _cuda.launches_into(entry.warmup_launches):
            graph.warmup(warmup)
        try:
            with _cuda.launches_into(entry.launches):
                graph.capture(fn)
        except RuntimeError as exc:
            raise GraphCaptureError(f"capturing the step {key!r} into a CUDA graph "
                                    f"failed: {exc}") from exc
        self._entries[key] = entry
        self.capture_seconds += time.perf_counter() - t0
        return entry
