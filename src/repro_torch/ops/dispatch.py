"""Dispatch: spec -> (call-site overrides, ``use()`` frames, validation) ->
backend (port of ``repro.ops.dispatch``).  Every resolution counts in the
process registry as ``ops.dispatch.calls{op, impl}``."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.obs.metrics import default_registry
from repro_torch.ops import registry
from repro_torch.ops.guard import Guard, as_guard
from repro_torch.ops.registry import Backend, OpDispatchError
from repro_torch.ops.specs import (
    AttentionSpec,
    MatmulSpec,
    PagedAttentionSpec,
    ScanSpec,
    SoftmaxSpec,
)

DEFAULT_SOFTMAX = SoftmaxSpec()
DEFAULT_ATTENTION = AttentionSpec()
DEFAULT_PAGED_ATTENTION = PagedAttentionSpec()
DEFAULT_MATMUL = MatmulSpec()
DEFAULT_SSD_SCAN = ScanSpec()


def resolve(spec, **overrides: Any) -> Tuple[Backend, Any]:
    """Apply overrides and ``use()`` frames, pick and validate the backend."""
    if overrides:
        try:
            spec = dataclasses.replace(spec, **overrides)
        except TypeError as exc:
            fields = [f.name for f in dataclasses.fields(spec)]
            raise OpDispatchError(
                f"invalid {type(spec).__name__} override(s) {sorted(overrides)}: "
                f"valid fields are {fields}"
            ) from exc
    forced = registry.active_impl(spec.op)
    if forced is not None:
        spec = dataclasses.replace(spec, impl=forced)
    backend = registry.get(spec.op, spec.impl)
    registry.validate(backend, spec)
    # counts dispatches: inside a captured CUDA graph that is capture time,
    # so a replayed tick counts once per capture, as the reference counts
    # a jitted call site once per trace
    default_registry().counter("ops.dispatch.calls").inc(op=spec.op, impl=backend.impl)
    return backend, spec


def _is_dtensor(x) -> bool:
    from repro_torch.distributed.sharding import is_dtensor

    return is_dtensor(x)


def validate(spec, **overrides: Any):
    """Resolve and capability-check a spec without running anything."""
    return resolve(spec, **overrides)[1]


def softmax(
    x: torch.Tensor,
    spec: Optional[SoftmaxSpec] = None,
    *,
    where: Optional[torch.Tensor] = None,
    axis: int = -1,
    guard: Optional[Guard] = None,
    **overrides: Any,
) -> torch.Tensor:
    """Softmax over ``axis`` through the backend selected by ``spec``.

    ``guard`` (an :class:`AccuracyGuard` or :class:`GuardConfig`) wraps the
    call in the accuracy guard: a sampled comparison against the exact
    oracle, and a clean backend when the error exceeds the tolerance."""
    backend, spec = resolve(spec if spec is not None else DEFAULT_SOFTMAX, **overrides)
    g = as_guard(guard)
    if g is not None:
        return g.softmax(backend, spec, x, where=where, axis=axis)
    if _is_dtensor(x):  # under a mesh: the backend runs on each rank's shard
        from repro_torch.distributed.sharding import softmax_on_shards

        return softmax_on_shards(lambda xl, **kw: backend.fn(spec, xl, **kw), x,
                                 where=where, axis=axis)
    return backend.fn(spec, x, where=where, axis=axis)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: Optional[AttentionSpec] = None,
    *,
    q_offset: Any = 0,
    kv_valid_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    **overrides: Any,
) -> torch.Tensor:
    """Attention: q ``[B,Tq,Hq,D]``, k/v ``[B,Tk,Hkv,D]`` -> ``[B,Tq,Hq,D]``."""
    backend, spec = resolve(spec if spec is not None else DEFAULT_ATTENTION, **overrides)
    if _is_dtensor(q):  # under a mesh: the backend runs on each rank's shard
        from repro_torch.distributed.sharding import (
            KVRowsShardedError, attention_on_shards, attention_rows_sharded, kv_rows_split)

        if kv_rows_split(k, q):  # a cache split along its rows: the split softmax
            if backend.impl not in ("reference", "xla"):
                raise KVRowsShardedError(
                    f"attention over K / V split along their rows runs the split softmax "
                    f"of the reference and xla routes; impl {backend.impl!r} needs whole "
                    f"rows (make the cache's rows whole, or use impl='xla')")
            if spec.softmax.fault is not None:
                raise KVRowsShardedError(
                    "attention over K / V split along their rows takes an ideal softmax: a "
                    "fault's realization is drawn for a whole row")
            from repro_torch.core.attention import SoftmaxConfig
            from repro_torch.core.attention import attention as materialized

            return attention_rows_sharded(
                lambda ql, kl, vl, **kw: materialized(
                    ql, kl, vl, softmax=SoftmaxConfig.from_spec(spec.softmax),
                    causal=spec.causal, sliding_window=spec.sliding_window, scale=scale, **kw),
                q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len)
        return attention_on_shards(
            lambda ql, kl, vl, **kw: backend.fn(spec, ql, kl, vl, scale=scale, **kw),
            q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len)
    return backend.fn(
        spec, q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale
    )


def paged_attention(
    q: torch.Tensor,  # [S, Tq, Hq, D] (decode: Tq == 1)
    k_pages: torch.Tensor,  # [N, bs, Hkv, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, W] int32
    spec: Optional[PagedAttentionSpec] = None,
    *,
    kv_valid_len: torch.Tensor,  # [S]
    kv_len: Optional[int] = None,
    scale: Optional[float] = None,
    kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # ([N,H], [N,H])
    **overrides: Any,
) -> torch.Tensor:
    """Paged-KV decode attention over each slot's ragged valid prefix.
    Returns ``[S, Tq, Hq, D]``.

    ``kv_scales`` carries the per-(block, head) dequant scale pages
    ``(k_scale, v_scale)`` of a quantized pool: required when
    ``spec.kv_dtype != "fp32"``, refused otherwise, so a layout / spec
    mismatch fails here instead of decoding garbage."""
    backend, spec = resolve(
        spec if spec is not None else DEFAULT_PAGED_ATTENTION, **overrides
    )
    if (spec.kv_dtype != "fp32") != (kv_scales is not None):
        raise OpDispatchError(
            f"kv_dtype={spec.kv_dtype!r} but kv_scales "
            f"{'missing' if kv_scales is None else 'supplied'}: quantized page "
            "pools must pass their (k_scale, v_scale) pages and fp32 pools must not"
        )
    return backend.fn(
        spec, q, k_pages, v_pages, block_tables,
        kv_valid_len=kv_valid_len, kv_len=kv_len, scale=scale, kv_scales=kv_scales,
    )


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    spec: Optional[MatmulSpec] = None,
    *,
    guard: Optional[Guard] = None,
    **overrides: Any,
) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` through the backend selected by ``spec``;
    ``guard`` as in :func:`softmax` (relative max-abs error against the
    exact product)."""
    backend, spec = resolve(spec if spec is not None else DEFAULT_MATMUL, **overrides)
    g = as_guard(guard)
    if g is not None:
        return g.matmul(backend, spec, x, w)
    return backend.fn(spec, x, w)


def ssd_scan(
    xdt: torch.Tensor,  # [B, T, H, P] float32, x pre-multiplied by dt
    a: torch.Tensor,  # [B, T, H] float32 log-decay (negative)
    bmat: torch.Tensor,  # [B, T, N]
    cmat: torch.Tensor,  # [B, T, N]
    spec: Optional[ScanSpec] = None,
    **overrides: Any,
):
    """Fused SSD chunk scan: ``(y [B,T,H,P], final state [B,H,N,P])``."""
    backend, spec = resolve(spec if spec is not None else DEFAULT_SSD_SCAN, **overrides)
    if _is_dtensor(xdt):  # under a mesh: the backend runs on each rank's shard
        from repro_torch.distributed.sharding import ssd_scan_on_shards

        return ssd_scan_on_shards(lambda *args: backend.fn(spec, *args), xdt, a, bmat, cmat)
    return backend.fn(spec, xdt, a, bmat, cmat)
