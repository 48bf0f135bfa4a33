"""Fault tolerance for the training loop (port of
``repro.distributed.fault``; plain Python, a copy).

* preemption (SIGTERM): flag the loop, which checkpoints and stops;
* stragglers: an EMA of the step's wall time; a step slower than
  ``threshold`` x the EMA is recorded;
* crashes: the loop resumes from the newest intact checkpoint (saves are
  atomic renames), and ``FailureInjector`` raises at a chosen step to test
  that.
"""

from __future__ import annotations

import signal
from typing import List, Optional


class PreemptionGuard:
    """Installs handlers for ``signals`` (SIGTERM) that set ``requested``
    instead of ending the process; restores the previous ones on exit."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False


class StragglerWatchdog:
    """EMA of the step time.  ``observe(dt)`` is True for a straggler: past
    ``warmup`` steps, slower than ``threshold`` x the EMA.  Stragglers are
    recorded in ``events`` and do not enter the EMA."""

    def __init__(self, threshold: float = 2.5, alpha: float = 0.1, warmup: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.count = 0
        self.events: List[dict] = []

    def observe(self, dt: float, step: int = -1) -> bool:
        self.count += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = self.count > self.warmup and dt > self.threshold * self.ema
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


class FailureInjector:
    """Raises ``RuntimeError`` at ``fail_at_step``, for restart tests."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
