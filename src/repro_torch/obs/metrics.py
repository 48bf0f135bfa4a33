"""Counters, gauges and histograms behind a registry — the part of the
reference's ``repro.obs.metrics`` the serve stack uses (own copy: the port
imports nothing of ``repro``).  Histograms keep every observation, so
percentiles are exact (nearest rank)."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self._value = name, help, 0.0

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self._value}


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
