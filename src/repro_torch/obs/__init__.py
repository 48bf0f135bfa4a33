"""``repro_torch.obs`` — the observability subsystem (the port of
``repro.obs``, DESIGN.md §10), stdlib at import (a recording tracer
imports torch at its first profiler range).

* **Tracing** (:mod:`repro_torch.obs.trace`): spans and explicit
  begin/end events into a bounded ring buffer; a process-global no-op
  tracer when disabled; Chrome trace-event JSON export.  While a
  :class:`Tracer` records, every span and begin/end pair is also a
  ``torch.profiler`` range of its name, so the program's spans sit on a
  profiled window's host timeline; ``Tracer.complete(name, start_s, end_s)``
  records a span after the fact from two readings of ``Tracer.now()``.
  The continuous engine's spans: the reference's (``serve.prefill``,
  ``serve.decode``, ...) and the port's own, ``serve.tick.upload`` /
  ``graph`` / ``sample`` / ``record`` inside ``serve.decode``, and the
  deferred ``serve.tick.device`` and ``serve.prefill.device`` (``device_ms``
  from CUDA events) and ``serve.queue_wait``.
* **Metrics** (:mod:`repro_torch.obs.metrics`): ``Counter`` / ``Gauge`` /
  ``Histogram`` behind a labeled :class:`MetricsRegistry` with
  ``snapshot() -> dict``.

    from repro_torch import obs

    tracer = obs.enable_tracing()   # before the engine is built
    ...                             # serve traffic
    tracer.export_chrome("trace.json")
    print(obs.default_registry().snapshot())
"""

from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    log_buckets,
    set_default_registry,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    TraceEvent,
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    set_tracer,
)


def reset() -> None:
    """Restore the no-op tracer and empty the global registry (tests)."""
    disable_tracing()
    default_registry().clear()
