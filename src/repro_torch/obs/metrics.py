"""Counters, gauges and histograms behind a registry — the part of the
reference's ``repro.obs.metrics`` the serve stack and the accuracy guard use
(own copy: the port imports nothing of ``repro``).  Counters keep one value
per label set; histograms keep every observation, so percentiles are exact
(nearest rank).  :func:`default_registry` is the process-global registry
that module-level producers (the accuracy guard's mirror) write to."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, Any], ...]


def _lkey(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic counter, one value per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        key = _lkey(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        return self._values.get(_lkey(labels), 0.0)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"value": self.value()}
        labelled = [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._values.items()) if k]
        if labelled:
            out["labelled"] = labelled
        return out


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self._value = name, help, 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self._value}


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._obs: List[float] = []

    def observe(self, value: float) -> None:
        self._obs.append(float(value))

    def count(self) -> int:
        return len(self._obs)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank ``p``-th percentile (0..100); None when empty."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if not self._obs:
            return None
        xs = sorted(self._obs)
        return xs[max(0, math.ceil(p / 100.0 * len(xs)) - 1)]

    def snapshot(self) -> Dict[str, Any]:
        n = len(self._obs)
        return {
            "count": n,
            "sum": sum(self._obs),
            "min": min(self._obs) if n else None,
            "max": max(self._obs) if n else None,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Name -> metric with get-or-create and kind checking."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} is a {m.kind}, not a {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, help)

    def snapshot(self) -> Dict[str, Any]:
        return {name: {"kind": m.kind, **m.snapshot()}
                for name, m in sorted(self._metrics.items())}


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry (the accuracy guard's counters)."""
    return _DEFAULT_REGISTRY


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests); returns the previous one."""
    global _DEFAULT_REGISTRY
    prev, _DEFAULT_REGISTRY = _DEFAULT_REGISTRY, registry
    return prev
