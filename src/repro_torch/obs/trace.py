"""Tracing: spans + events into a bounded ring buffer, Chrome-trace export
(the port's own copy of the reference's ``repro.obs.trace``, DESIGN.md §10:
the port imports nothing of ``repro``, so it keeps this module as its own;
the events it writes are the reference's, field for field).

The serving stack needs stage-level visibility — where a request's time
goes between enqueue, admission, prefill, decode ticks, and finish —
without taxing the hot path when nobody is looking.  Two tracer
implementations share one duck-typed surface:

* :class:`Tracer` — records :class:`TraceEvent` rows into a
  ``deque(maxlen=capacity)`` ring buffer (old events fall off and are
  counted in ``dropped``) and exports them as Chrome trace-event JSON
  (``chrome://tracing`` / https://ui.perfetto.dev).  The time source is
  injectable (``clock=``, a zero-arg callable returning seconds) so tests
  assert exact timestamps.
* :class:`NullTracer` — the process-global default.  Every method is a
  no-op returning shared singletons: ``span()`` hands back one reusable
  context manager, so a disabled trace point costs one attribute lookup
  and one call — no event object, no timestamp read, no buffer append.

Instrumentation sites hold a tracer reference and call it unconditionally;
sites that would *build* arguments (lists of uids) gate on
``tracer.enabled`` first.  The global tracer is swapped with
:func:`enable_tracing` / :func:`disable_tracing` / :func:`set_tracer`;
engines capture :func:`get_tracer` at construction.

Event vocabulary (Chrome trace-event ``ph`` codes):

* ``span(name, **args)`` — a complete ``"X"`` event (begin time + dur).
* ``begin(name)`` / ``end(name)`` — explicit ``"B"`` / ``"E"`` pairs for
  regions that cannot be a ``with`` block.
* ``async_begin/async_end(name, id)`` — ``"b"`` / ``"e"`` events keyed by
  ``id``: one open span per *request* across many ticks.
* ``instant(name, **args)`` — an ``"i"`` marker (preemption, guard trip).
* ``counter(name, **values)`` — a ``"C"`` sample (queue depth, block
  occupancy) rendered as a stacked counter track.
* ``complete(name, start_s, end_s, **args)`` — an ``"X"`` event recorded
  after the fact, from two readings of the tracer's own clock (``now()``):
  a span whose length is known only later (a device time read from CUDA
  events, a queue wait measured at admission).

The profiler bridge: while a :class:`Tracer` records, every ``span`` and
every ``begin`` / ``end`` pair also opens a ``torch.profiler`` range of the
same name (``record_function``'s fast form), so a profiled window shows
the program's spans on the host timeline beside the kernels they launched.
``complete`` opens none: its region is over when it is recorded.

Stdlib at import: torch is imported at a recording tracer's first range,
so the host-side scheduler and block pool depend on this module freely and
the :class:`NullTracer` never touches torch.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

_RANGE = None  # the profiler range's type, once torch is imported


def _open_range(name: str):
    """Open a ``torch.profiler`` range named ``name``; returns it, for
    :func:`_close_range`.  The range is torch's fast record-function, a C++
    object: about a microsecond a range against tens for ``record_function``."""
    global _RANGE
    if _RANGE is None:
        import torch

        _RANGE = torch._C._profiler._RecordFunctionFast
    r = _RANGE(name)
    r.__enter__()
    return r


def _close_range(r) -> None:
    r.__exit__(None, None, None)


@dataclasses.dataclass
class TraceEvent:
    """One trace-event row (field names mirror the Chrome JSON keys)."""

    name: str
    ph: str  # B | E | X | i | b | e | C
    ts: float  # microseconds since the tracer's epoch
    dur: Optional[float] = None  # X only: span duration in microseconds
    tid: int = 0
    cat: str = "repro"
    id: Optional[int] = None  # async (b/e) correlation id
    args: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "name": self.name,
            "ph": self.ph,
            "ts": self.ts,
            "pid": 0,
            "tid": self.tid,
            "cat": self.cat,
        }
        if self.dur is not None:
            row["dur"] = self.dur
        if self.id is not None:
            row["id"] = self.id
        if self.args:
            row["args"] = self.args
        return row


class _Span:
    """Context manager recording one complete ("X") event on exit, inside a
    profiler range of the same name."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._range = _open_range(self._name)
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = self._tracer._now_us()
        _close_range(self._range)
        self._tracer._append(TraceEvent(
            self._name, "X", self._t0, dur=t1 - self._t0,
            tid=threading.get_ident() & 0xFFFFFF, cat=self._cat,
            args=self._args or None,
        ))
        return False


class Tracer:
    """Recording tracer: bounded ring buffer + Chrome-trace JSON export.

    ``capacity`` bounds the buffer (oldest events are dropped and counted
    in ``dropped``); ``clock`` is a zero-arg callable returning seconds —
    ``time.perf_counter`` by default, a fake clock in tests.  Timestamps
    are microseconds relative to the tracer's construction, which is what
    the Chrome trace-event format expects.
    """

    enabled = True

    def __init__(
        self,
        *,
        capacity: int = 65536,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._clock = clock
        self._epoch = clock()
        self._buf: deque[TraceEvent] = deque(maxlen=capacity)
        self.dropped = 0
        self._ranges: Dict[str, List[Any]] = {}  # begin()'s open profiler ranges by name

    # -- recording -----------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    def now(self) -> float:
        """The tracer's clock, in seconds: the readings ``complete`` takes."""
        return self._clock()

    def _append(self, event: TraceEvent) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(event)

    def span(self, name: str, *, cat: str = "repro", **args: Any) -> _Span:
        return _Span(self, name, cat, args)

    def begin(self, name: str, *, cat: str = "repro", **args: Any) -> None:
        self._ranges.setdefault(name, []).append(_open_range(name))
        self._append(TraceEvent(
            name, "B", self._now_us(),
            tid=threading.get_ident() & 0xFFFFFF, cat=cat, args=args or None,
        ))

    def end(self, name: str, *, cat: str = "repro") -> None:
        self._append(TraceEvent(
            name, "E", self._now_us(),
            tid=threading.get_ident() & 0xFFFFFF, cat=cat,
        ))
        open_ = self._ranges.get(name)
        if open_:
            _close_range(open_.pop())

    def complete(self, name: str, start_s: float, end_s: float, *, cat: str = "repro",
                 **args: Any) -> None:
        """A complete ("X") event from ``start_s`` to ``end_s``, two readings
        of :meth:`now`, recorded after the fact (no profiler range)."""
        t0, t1 = (start_s - self._epoch) * 1e6, (end_s - self._epoch) * 1e6
        self._append(TraceEvent(
            name, "X", t0, dur=t1 - t0,
            tid=threading.get_ident() & 0xFFFFFF, cat=cat, args=args or None,
        ))

    def async_begin(self, name: str, id: int, *, cat: str = "request",
                    **args: Any) -> None:
        self._append(TraceEvent(
            name, "b", self._now_us(), cat=cat, id=id, args=args or None,
        ))

    def async_end(self, name: str, id: int, *, cat: str = "request") -> None:
        self._append(TraceEvent(name, "e", self._now_us(), cat=cat, id=id))

    def instant(self, name: str, *, cat: str = "repro", **args: Any) -> None:
        self._append(TraceEvent(
            name, "i", self._now_us(),
            tid=threading.get_ident() & 0xFFFFFF, cat=cat, args=args or None,
        ))

    def counter(self, name: str, *, cat: str = "repro", **values: float) -> None:
        self._append(TraceEvent(
            name, "C", self._now_us(),
            tid=threading.get_ident() & 0xFFFFFF, cat=cat, args=dict(values),
        ))

    # -- introspection / export ----------------------------------------------

    @property
    def events(self) -> List[TraceEvent]:
        return list(self._buf)

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (viewable in Perfetto)."""
        return {
            "traceEvents": [e.to_json() for e in self._buf],
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def export_chrome(self, path: str) -> str:
        """Write the Chrome trace JSON to ``path``; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: shared singletons everywhere, nothing recorded.

    ``span()`` returns one preallocated context manager, so an
    instrumented hot loop with tracing disabled pays a method call and
    nothing else — no event objects, no clock reads, no buffer traffic, no
    profiler range (tests/test_obs.py pins this: zero events after a full
    serve run).
    """

    enabled = False
    events: List[TraceEvent] = []
    dropped = 0

    def span(self, name: str, *, cat: str = "repro", **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def begin(self, name: str, *, cat: str = "repro", **args: Any) -> None:
        pass

    def end(self, name: str, *, cat: str = "repro") -> None:
        pass

    def async_begin(self, name: str, id: int, *, cat: str = "request",
                    **args: Any) -> None:
        pass

    def async_end(self, name: str, id: int, *, cat: str = "request") -> None:
        pass

    def instant(self, name: str, *, cat: str = "repro", **args: Any) -> None:
        pass

    def counter(self, name: str, *, cat: str = "repro", **values: float) -> None:
        pass

    def now(self) -> float:
        return 0.0  # no clock is read

    def complete(self, name: str, start_s: float, end_s: float, *, cat: str = "repro",
                 **args: Any) -> None:
        pass

    def clear(self) -> None:
        pass

    def chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms",
                "otherData": {"dropped_events": 0}}


NULL_TRACER = NullTracer()

_GLOBAL_TRACER: "Tracer | NullTracer" = NULL_TRACER


def get_tracer() -> "Tracer | NullTracer":
    """The process-global tracer (the no-op singleton unless enabled)."""
    return _GLOBAL_TRACER


def set_tracer(tracer: "Tracer | NullTracer") -> "Tracer | NullTracer":
    """Install ``tracer`` globally; returns the previous one."""
    global _GLOBAL_TRACER
    prev, _GLOBAL_TRACER = _GLOBAL_TRACER, tracer
    return prev


def enable_tracing(
    *,
    capacity: int = 65536,
    clock: Callable[[], float] = time.perf_counter,
) -> Tracer:
    """Install (and return) a fresh recording tracer as the global one."""
    tracer = Tracer(capacity=capacity, clock=clock)
    set_tracer(tracer)
    return tracer


def disable_tracing() -> None:
    """Restore the no-op global tracer."""
    set_tracer(NULL_TRACER)
