"""Capability-checked backend registry (port of ``repro.ops.registry``).

Backends register under ``(op, impl)`` with a capability table mapping spec
field paths (dotted for nested specs, e.g. ``"softmax.kind"``) to the values
they support; dispatch validates before calling.  ``use(...)`` pushes a
context-local override frame that retargets every dispatch in its block.
"""

from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple


class OpDispatchError(ValueError):
    """Base class for dispatch-layer errors."""


class UnknownBackendError(OpDispatchError):
    """No backend registered under the requested (op, impl)."""


class CapabilityError(OpDispatchError):
    """The selected backend cannot execute the requested spec."""


@dataclasses.dataclass(frozen=True)
class Backend:
    op: str
    impl: str
    fn: Callable[..., Any]
    capabilities: Mapping[str, Tuple[Any, ...]] = dataclasses.field(default_factory=dict)
    description: str = ""


_REGISTRY: Dict[Tuple[str, str], Backend] = {}


def register(
    op: str,
    impl: str,
    fn: Callable[..., Any],
    *,
    capabilities: Optional[Mapping[str, Tuple[Any, ...]]] = None,
    description: str = "",
    overwrite: bool = False,
) -> Backend:
    """Register (or with ``overwrite=True`` replace) a backend."""
    key = (op, impl)
    if key in _REGISTRY and not overwrite:
        raise OpDispatchError(
            f"backend {impl!r} already registered for op {op!r}; "
            "pass overwrite=True to replace it"
        )
    backend = Backend(op, impl, fn, dict(capabilities or {}), description)
    _REGISTRY[key] = backend
    return backend


def unregister(op: str, impl: str) -> None:
    _REGISTRY.pop((op, impl), None)


def backends(op: str) -> Tuple[Backend, ...]:
    """All registered backends for an op, sorted by impl name."""
    found = [b for (o, _), b in _REGISTRY.items() if o == op]
    return tuple(sorted(found, key=lambda b: b.impl))


def registered_ops() -> Tuple[str, ...]:
    """All op names with at least one registered backend."""
    return tuple(sorted({o for (o, _) in _REGISTRY}))


def get(op: str, impl: str) -> Backend:
    backend = _REGISTRY.get((op, impl))
    if backend is None:
        known = sorted(b.impl for b in backends(op))
        if not known:
            raise UnknownBackendError(
                f"no backends registered for op {op!r} (is repro_torch.ops.impls imported?)")
        raise UnknownBackendError(
            f"no {op!r} backend named {impl!r}; registered impls: {known}"
        )
    return backend


def _field_value(spec: Any, path: str) -> Any:
    value = spec
    for part in path.split("."):
        value = getattr(value, part)
    return value


def validate(backend: Backend, spec: Any) -> None:
    """Raise :class:`CapabilityError` unless ``backend`` can execute ``spec``."""
    for path, allowed in backend.capabilities.items():
        value = _field_value(spec, path)
        if value not in allowed:
            others = sorted(
                b.impl for b in backends(backend.op)
                if b.impl != backend.impl
                and value in b.capabilities.get(path, (value,))
            )
            hint = f"; impls supporting {path}={value!r}: {others}" if others else ""
            raise CapabilityError(
                f"{backend.op} backend {backend.impl!r} does not support "
                f"{path}={value!r} (supported: {list(allowed)}){hint}"
            )


_OVERRIDE_FRAMES: ContextVar[Tuple[Mapping[str, Any], ...]] = ContextVar(
    "repro_torch_ops_overrides", default=()
)
_OVERRIDE_KEYS = ("softmax", "attention", "paged_attention", "matmul", "ssd_scan")


@contextlib.contextmanager
def use(**overrides: str) -> Iterator[None]:
    """Retarget dispatch inside the ``with`` block: keys are op names,
    values the impl to force.  Inner frames win over outer frames; both win
    over the spec's own ``impl``."""
    bad = sorted(set(overrides) - set(_OVERRIDE_KEYS))
    if bad:
        raise OpDispatchError(
            f"unknown ops.use() keys {bad}; valid keys: {list(_OVERRIDE_KEYS)}"
        )
    token = _OVERRIDE_FRAMES.set(_OVERRIDE_FRAMES.get() + (dict(overrides),))
    try:
        yield
    finally:
        _OVERRIDE_FRAMES.reset(token)


def active_overrides(op: str) -> Dict[str, Any]:
    """The override stack collapsed for one op: ``{"impl": ...}`` when a
    ``use()`` frame forces it, else ``{}`` (the reference's dict may also
    hold ``"interpret"``, an override the port does not have)."""
    out: Dict[str, Any] = {}
    for frame in _OVERRIDE_FRAMES.get():
        if op in frame:
            out["impl"] = frame[op]
    return out


def active_impl(op: str) -> Optional[str]:
    """The impl the innermost ``use()`` frame forces for ``op``, if any."""
    return active_overrides(op).get("impl")


def active_impls() -> Tuple[Tuple[str, str], ...]:
    """``(op, impl)`` for every op a ``use()`` frame forces, in a fixed
    order: the overrides a captured CUDA graph resolved its routes under."""
    forced = ((op, active_impl(op)) for op in _OVERRIDE_KEYS)
    return tuple((op, impl) for op, impl in forced if impl is not None)
