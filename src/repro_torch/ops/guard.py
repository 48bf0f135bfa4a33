"""Accuracy-guarded dispatch: compare against the exact oracle, fall back
(port of ``repro.ops.guard``).

An :class:`AccuracyGuard` attached to a dispatch call
(``ops.softmax(x, spec, guard=g)``, ``ops.matmul(x, w, spec, guard=g)``)
re-runs a deterministic sample of calls (every ``sample_every``-th) through
the exact oracle.  When the observed error exceeds the tolerance it warns
with a structured :class:`GuardTripWarning` and re-dispatches the call on a
clean backend (fault stripped, ``fallback_impl``).  Counters live on the
guard instance and mirror into the process registry
(``obs.metrics.default_registry``) as ``ops.guard.{calls,checks,fallbacks,
trips}``, labelled by ``op`` (and ``impl`` for trips); the serving engine
reports them in ``ContinuousBatchingEngine.stats()["guard"]``.  A trip is
also a ``guard.trip`` instant in the active trace (``obs.get_tracer()``).

Latching: after the first trip (``latch=True``, the default) every guarded
call goes straight to the clean backend; ``latch=False`` keeps running and
checking the degraded backend.

The softmax oracle is the fallback backend run with ``kind="exact"``; a
fallback that cannot compute the exact softmax (``"pallas"``: its kernels
are STAR only) is refused with an :class:`OpDispatchError` at the first
guarded call.  (The reference fails there with an ``AttributeError`` inside
its kernel.)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Union

from repro_torch.kernels.crossbar_matmul.ref import exact_matmul_ref
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import get_tracer
from repro_torch.ops import registry
from repro_torch.ops.registry import CapabilityError, OpDispatchError


class GuardTripWarning(UserWarning):
    """A guarded dispatch exceeded its tolerance and fell back.  ``op``,
    ``impl``, ``error``, ``tolerance`` and ``fallback_impl`` are attributes."""

    def __init__(self, op: str, impl: str, error: float, tolerance: float, fallback_impl: str):
        self.op = op
        self.impl = impl
        self.error = error
        self.tolerance = tolerance
        self.fallback_impl = fallback_impl
        super().__init__(
            f"{op} backend {impl!r} exceeded its accuracy contract "
            f"(error {error:.3e} > tolerance {tolerance:.3e}); falling "
            f"back to the clean {fallback_impl!r} backend"
        )


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Policy half of the guard (counters live on :class:`AccuracyGuard`).

    ``sample_every``: check every Nth guarded call (1 = every call).
    ``tolerance``: the error budget; ``None`` uses the spec's own contract
    (``SoftmaxSpec.tolerance()``) for softmax and ``matmul_rtol`` (relative
    max-abs error) for matmul.  ``fallback_impl``: the clean backend; ``None``
    picks ``"reference"`` for softmax and ``"xla"`` for matmul.  ``latch``:
    once tripped, stop dispatching the degraded backend.
    """

    sample_every: int = 1
    tolerance: Optional[float] = None
    fallback_impl: Optional[str] = None
    latch: bool = True
    matmul_rtol: float = 0.05

    def __post_init__(self) -> None:
        if self.sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {self.sample_every}")
        if self.tolerance is not None and self.tolerance <= 0.0:
            raise ValueError(f"tolerance must be > 0, got {self.tolerance}")


def clean_spec(spec, impl: str):
    """Degradation-free twin of ``spec`` on backend ``impl``: the fault
    model and quantized KV storage are stripped where the spec has them."""
    updates: dict = {"impl": impl}
    names = {f.name for f in dataclasses.fields(spec)}
    if "fault" in names:
        updates["fault"] = None
    if "kv_dtype" in names:
        updates["kv_dtype"] = "fp32"
    return dataclasses.replace(spec, **updates)


class AccuracyGuard:
    """Stateful guard: counters and the trip latch.  Reuse one instance
    across calls; a fresh guard per call cannot accumulate or latch."""

    def __init__(self, config: GuardConfig = GuardConfig()):
        self.config = config
        self.calls = 0  # guarded dispatches seen
        self.checks = 0  # oracle comparisons run
        self.trips = 0  # tolerance violations observed
        self.fallbacks = 0  # calls served by the clean backend
        self.tripped = False  # latch state
        self.last_error: Optional[float] = None

    def stats(self) -> Dict[str, Any]:
        return {
            "calls": self.calls,
            "checks": self.checks,
            "trips": self.trips,
            "fallbacks": self.fallbacks,
            "tripped": self.tripped,
            "last_error": self.last_error,
        }

    # -- internals -----------------------------------------------------------

    def _should_check(self) -> bool:
        return (self.calls - 1) % self.config.sample_every == 0

    def _fallback_impl(self, op: str) -> str:
        if self.config.fallback_impl is not None:
            return self.config.fallback_impl
        return "reference" if op == "softmax" else "xla"

    @staticmethod
    def _note(event: str, op: str) -> None:
        default_registry().counter(f"ops.guard.{event}").inc(op=op)

    def _trip(self, op: str, impl: str, err: float, tol: float) -> None:
        self.trips += 1
        self.tripped = True
        fallback = self._fallback_impl(op)
        default_registry().counter("ops.guard.trips").inc(op=op, impl=impl)
        tracer = get_tracer()
        if tracer.enabled:
            tracer.instant("guard.trip", cat="guard", op=op, impl=impl, error=err,
                           tolerance=tol, fallback=fallback)
        warnings.warn(GuardTripWarning(op, impl, err, tol, fallback), stacklevel=4)

    # -- guarded ops ---------------------------------------------------------

    def softmax(self, backend, spec, x, *, where=None, axis=-1):
        """Guarded softmax dispatch (called by ``ops.dispatch.softmax``)."""
        cfg = self.config
        fb = self._fallback_impl("softmax")
        clean = clean_spec(spec, fb)
        fallback = registry.get("softmax", fb)
        exact = dataclasses.replace(clean, kind="exact", precision=spec.precision)
        try:
            registry.validate(fallback, exact)
        except CapabilityError as exc:
            raise OpDispatchError(
                f"GuardConfig(fallback_impl={fb!r}) cannot serve the softmax guard: its "
                f"oracle runs the fallback backend with kind='exact' ({exc})"
            ) from exc
        if self.tripped and cfg.latch:
            self.calls += 1
            self.fallbacks += 1
            self._note("calls", "softmax")
            self._note("fallbacks", "softmax")
            return fallback.fn(clean, x, where=where, axis=axis)
        out = backend.fn(spec, x, where=where, axis=axis)
        self.calls += 1
        self._note("calls", "softmax")
        if not self._should_check():
            return out
        self.checks += 1
        self._note("checks", "softmax")
        ref = fallback.fn(exact, x, where=where, axis=axis)
        err = float((out.float() - ref.float()).abs().max())
        self.last_error = err
        tol = cfg.tolerance if cfg.tolerance is not None else spec.tolerance()
        if err > tol:
            self._trip("softmax", spec.impl, err, tol)
            self.fallbacks += 1
            self._note("fallbacks", "softmax")
            return fallback.fn(clean, x, where=where, axis=axis)
        return out

    def matmul(self, backend, spec, x, w):
        """Guarded matmul dispatch: relative max-abs error against the exact
        product (summed in float64, so no TF32 setting moves the oracle)."""
        cfg = self.config
        fb = self._fallback_impl("matmul")
        clean = clean_spec(spec, fb)
        fallback = registry.get("matmul", fb)
        if self.tripped and cfg.latch:
            self.calls += 1
            self.fallbacks += 1
            self._note("calls", "matmul")
            self._note("fallbacks", "matmul")
            return fallback.fn(clean, x, w)
        out = backend.fn(spec, x, w)
        self.calls += 1
        self._note("calls", "matmul")
        if not self._should_check():
            return out
        self.checks += 1
        self._note("checks", "matmul")
        ref = exact_matmul_ref(x, w)
        denom = float(ref.abs().max()) or 1.0
        err = float((out.float() - ref).abs().max()) / denom
        self.last_error = err
        tol = cfg.tolerance if cfg.tolerance is not None else cfg.matmul_rtol
        if err > tol:
            self._trip("matmul", spec.impl, err, tol)
            self.fallbacks += 1
            self._note("fallbacks", "matmul")
            return fallback.fn(clean, x, w)
        return out


Guard = Union[AccuracyGuard, GuardConfig]


def as_guard(guard: Optional[Guard]) -> Optional[AccuracyGuard]:
    """Normalize ``guard=``: an :class:`AccuracyGuard` is reused (counters
    accumulate), a :class:`GuardConfig` wrapped fresh, ``None`` passed on."""
    if guard is None or isinstance(guard, AccuracyGuard):
        return guard
    if isinstance(guard, GuardConfig):
        return AccuracyGuard(guard)
    raise OpDispatchError(
        f"guard must be an AccuracyGuard, GuardConfig, or None; got {type(guard).__name__}"
    )
