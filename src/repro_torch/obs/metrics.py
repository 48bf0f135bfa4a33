"""Metrics: Counter / Gauge / Histogram behind a labeled registry (the
port's own copy of the reference's ``repro.obs.metrics``, DESIGN.md §10).

Traces answer *where did this request's time go*, metrics answer *what is
the engine doing* — request rates, queue depths, block-pool occupancy,
transfer bytes, latency percentiles — as a ``snapshot()`` dict cheap
enough to merge into ``ContinuousBatchingEngine.stats()`` every call.

* :class:`Counter` — monotonically increasing per label-set
  (``c.inc(op="softmax", impl="pallas")``).
* :class:`Gauge` — last-write-wins level (queue depth, slot occupancy).
* :class:`Histogram` — fixed log-spaced buckets (:func:`log_buckets`):
  observations land in geometric bins so one layout spans microseconds
  to minutes with bounded relative error; ``sum``/``min``/``max`` are
  kept exactly, ``percentile(p)`` interpolates within the bucket.  The
  same observations always give the same percentile estimate.
* :class:`MetricsRegistry` — name -> metric, get-or-create with kind
  checking, ``snapshot() -> dict``.  Engines own private registries;
  module-level producers (``ops.dispatch``, the accuracy guard) write to
  :func:`default_registry`.

Labels are kwargs; a label-set is keyed by its sorted item tuple, so
``inc(a=1, b=2)`` and ``inc(b=2, a=1)`` hit the same series.  Pure stdlib.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, Any], ...]


def _lkey(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted(labels.items()))


def log_buckets(
    lo: float = 1e-6, hi: float = 100.0, per_decade: int = 5
) -> Tuple[float, ...]:
    """Geometric bucket upper bounds from ``lo`` to at least ``hi``.

    ``per_decade`` bounds the relative quantization error of percentile
    estimates: 5/decade means neighbouring bounds differ by ~1.58x.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = math.ceil(per_decade * math.log10(hi / lo))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


DEFAULT_TIME_BUCKETS = log_buckets(1e-6, 100.0, per_decade=5)


class Counter:
    """Monotonic counter, one value per label-set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        key = _lkey(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return self._values.get(_lkey(labels), 0.0)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [
            {"labels": dict(k), "value": v}
            for k, v in sorted(self._values.items())
        ]


class Gauge:
    """Last-write-wins level, one value per label-set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        self._values[_lkey(labels)] = value

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _lkey(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: Any) -> float:
        return self._values.get(_lkey(labels), 0.0)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [
            {"labels": dict(k), "value": v}
            for k, v in sorted(self._values.items())
        ]


class _HistSeries:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # one extra overflow bucket at the end
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram:
    """Fixed-bucket histogram with exact sum/min/max per label-set.

    ``buckets`` are inclusive upper bounds; an implicit overflow bucket
    catches everything above the last bound.  The default layout is
    log-spaced over seconds (1 µs .. 100 s) — right for the latency
    histograms this subsystem exists for.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ):
        self.name = name
        self.help = help
        bs = tuple(buckets) if buckets is not None else DEFAULT_TIME_BUCKETS
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram {name}: buckets must strictly increase")
        if not bs:
            raise ValueError(f"histogram {name}: need at least one bucket")
        self.buckets = bs
        self._series: Dict[LabelKey, _HistSeries] = {}

    def _get(self, labels: Dict[str, Any]) -> _HistSeries:
        key = _lkey(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets) + 1)
        return s

    def _bucket_index(self, value: float) -> int:
        # linear scan is fine for <=40 buckets and beats bisect's call
        # overhead at the sizes we use; the hot path is host-side anyway
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                return i
        return len(self.buckets)

    def observe(self, value: float, **labels: Any) -> None:
        s = self._get(labels)
        s.counts[self._bucket_index(value)] += 1
        s.count += 1
        s.sum += value
        if value < s.min:
            s.min = value
        if value > s.max:
            s.max = value

    def count(self, **labels: Any) -> int:
        s = self._series.get(_lkey(labels))
        return s.count if s is not None else 0

    def percentile(self, p: float, **labels: Any) -> Optional[float]:
        """Estimate the ``p``-th percentile (0..100) by interpolating
        within the bucket the rank falls into, clamped to the exact
        observed ``[min, max]``.  ``None`` when the series is empty."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        s = self._series.get(_lkey(labels))
        if s is None or s.count == 0:
            # zero-count edge: never leak the ±inf min/max sentinels
            return None
        if s.count == 1 or s.min == s.max:
            # one observation (or a constant series) has an exact answer;
            # skipping interpolation keeps ±inf out of the arithmetic even
            # when the single sample sits in the overflow bucket
            return s.min
        rank = p / 100.0 * s.count
        cum = 0
        for i, n in enumerate(s.counts):
            if n == 0:
                continue
            if cum + n >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else s.max
                frac = (rank - cum) / n
                est = lo + (hi - lo) * max(frac, 0.0)
                return min(max(est, s.min), s.max)
            cum += n
        return s.max

    def snapshot(self) -> List[Dict[str, Any]]:
        out = []
        for key, s in sorted(self._series.items()):
            kw = dict(key)
            out.append({
                "labels": kw,
                "count": s.count,
                "sum": s.sum,
                # both bounds need the zero-count guard: an empty series
                # holds the +inf/-inf init sentinels, which are not JSON
                # and must never escape a snapshot
                "min": s.min if s.count else None,
                "max": s.max if s.count else None,
                "p50": self.percentile(50, **kw),
                "p95": self.percentile(95, **kw),
                "p99": self.percentile(99, **kw),
            })
        return out


Metric = Any  # Counter | Gauge | Histogram


class MetricsRegistry:
    """Name -> metric map with get-or-create and kind checking."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls: type, name: str, **kwargs: Any) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kwargs)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} is already registered as a {m.kind}, "
                f"not a {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help=help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help=help, buckets=buckets)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """{name: {"kind": ..., "series": [...]}} for every metric."""
        return {
            name: {"kind": m.kind, "series": m.snapshot()}
            for name, m in sorted(self._metrics.items())
        }

    def clear(self) -> None:
        self._metrics.clear()


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry module-level producers write to
    (``ops.dispatch`` call counters, accuracy-guard counters)."""
    return _DEFAULT_REGISTRY


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests); returns the previous one."""
    global _DEFAULT_REGISTRY
    prev, _DEFAULT_REGISTRY = _DEFAULT_REGISTRY, registry
    return prev
