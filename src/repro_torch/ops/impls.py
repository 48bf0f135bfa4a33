"""Built-in backends (port of ``repro.ops.impls``).

Each backend adapts the spec contract to an engine: the plain versions in
``repro_torch.core`` or one of the Hopper kernels in
``repro_torch.kernels``.  Numerics live there; this file only routes.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.attention import (
    NEG_INF,
    SoftmaxConfig,
    attention as full_attention,
    blocked_attention,
)
from repro_torch.core.kvquant import KV_DTYPES
from repro_torch.core.star_softmax import exact_softmax, star_softmax, star_softmax_ste
from repro_torch.kernels.crossbar_matmul.kernel import crossbar_matmul
from repro_torch.kernels.crossbar_matmul.ref import prepare_operands
from repro_torch.kernels.flash_star import flash_star_attention
from repro_torch.kernels.paged_attention import paged_flash_attention
from repro_torch.kernels.paged_attention.ref import gather_pages
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.kernels.star_softmax import star_softmax_kernel
from repro_torch.ops.registry import CapabilityError, register
from repro_torch.ops.specs import (
    AttentionSpec,
    MatmulSpec,
    PagedAttentionSpec,
    ScanSpec,
    SoftmaxSpec,
)

# ---------------------------------------------------------------------------
# softmax


def _masked(x: torch.Tensor, where: Optional[torch.Tensor]) -> torch.Tensor:
    return x if where is None else torch.where(where, x, torch.full_like(x, NEG_INF))


def _softmax_reference(spec: SoftmaxSpec, x, *, where=None, axis=-1):
    if spec.kind == "exact":
        return exact_softmax(_masked(x, where), axis=axis)
    if spec.kind == "star_ste":  # NEG_INF quantizes to the deepest LUT row
        return star_softmax_ste(_masked(x, where), spec.fmt, axis, spec.mode, spec.fault)
    return star_softmax(x, spec.fmt, axis=axis, mode=spec.mode, where=where,
                        fault=spec.fault)


def _softmax_xla(spec: SoftmaxSpec, x, *, where=None, axis=-1):
    return torch.softmax(_masked(x, where), dim=axis)


def _softmax_pallas(spec: SoftmaxSpec, x, *, where=None, axis=-1):
    if where is not None:
        raise CapabilityError(
            "softmax backend 'pallas' does not take a `where` mask (the kernel "
            "streams dense rows); mask upstream or use impl='reference'"
        )
    out = star_softmax_kernel(torch.movedim(x, axis, -1), spec.fmt, mode=spec.mode,
                              fault=spec.fault)
    return torch.movedim(out, -1, axis)


register("softmax", "reference", _softmax_reference,
         description="plain STAR engine / FP oracle (core.star_softmax)")
register("softmax", "xla", _softmax_xla,
         capabilities={"kind": ("exact",), "fault": (None,)},
         description="torch.softmax — the exact FP path")
register("softmax", "pallas", _softmax_pallas, capabilities={"kind": ("star",)},
         description="STAR row softmax kernel: CUDA, one thread-block cluster a row, "
         "every mode and fault (kernels.star_softmax)")


# ---------------------------------------------------------------------------
# attention


def _attention_reference(spec: AttentionSpec, q, k, v, *, q_offset=0,
                         kv_valid_len=None, scale=None):
    return full_attention(
        q, k, v, softmax=SoftmaxConfig.from_spec(spec.softmax),
        causal=spec.causal, sliding_window=spec.sliding_window,
        q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale,
    )


def _attention_xla(spec: AttentionSpec, q, k, v, *, q_offset=0,
                   kv_valid_len=None, scale=None):
    # short rows and single-token decode take the materialized path, and so
    # does a faulty engine: the online rescale lut[a] * lut[b] == lut[a + b]
    # fails for a faulty LUT (this keeps xla bit-identical to reference)
    if q.shape[1] == 1 or k.shape[1] <= spec.block_kv or spec.softmax.fault is not None:
        return _attention_reference(spec, q, k, v, q_offset=q_offset,
                                    kv_valid_len=kv_valid_len, scale=scale)
    return blocked_attention(
        q, k, v, softmax=SoftmaxConfig.from_spec(spec.softmax),
        causal=spec.causal, sliding_window=spec.sliding_window,
        q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale,
        block_size=spec.block_kv,
    )


def _flash_info(q_offset, kv_valid_len, b: int, tk: int, device) -> torch.Tensor:
    """The kernel's int32 info vector ``[q_offset, kv_valid…]``, made on
    ``device`` with no host upload (a CUDA graph cannot capture one): a
    Python ``q_offset`` (the dense decode's 0, a chunk's start) becomes a
    device-side fill, a tensor one (the lockstep cache's ``len``) is read
    where it lives."""
    if isinstance(q_offset, torch.Tensor):
        offset = q_offset.to(device=device, dtype=torch.int32).reshape(1)
    else:
        offset = torch.full((1,), int(q_offset), dtype=torch.int32, device=device)
    if kv_valid_len is None:
        valid = torch.full((b,), tk, dtype=torch.int32, device=device)
    else:
        valid = torch.as_tensor(kv_valid_len, device=device).to(torch.int32).reshape(b)
    return torch.cat([offset, valid])


def _attention_pallas(spec: AttentionSpec, q, k, v, *, q_offset=0,
                      kv_valid_len=None, scale=None):
    # [B, T, H, D] -> the kernel's heads-major views (no copy), with
    # (q_offset, per-batch valid lengths) packed into the info vector
    info = _flash_info(q_offset, kv_valid_len, q.shape[0], k.shape[1], q.device)
    out = flash_star_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), info,
        fmt=spec.softmax.fmt, causal=spec.causal,
        sliding_window=spec.sliding_window, sm_scale=scale,
        block_k=spec.block_k, pv_int8=spec.pv_int8,
    )
    return out.transpose(1, 2)


register("attention", "reference", _attention_reference,
         capabilities={"pv_int8": (False,)},
         description="whole-operand attention, scores materialized (core.attention)")
register("attention", "xla", _attention_xla, capabilities={"pv_int8": (False,)},
         description="online-blocked loop over KV blocks (core.attention); "
         "materialized for short rows / single-token decode")
register("attention", "pallas", _attention_pallas,
         # online-rescale kernel: no per-cell fault path
         capabilities={"softmax.kind": ("star", "exact"), "softmax.fault": (None,)},
         description="CUDA flash_star kernel (kernels.flash_star)")
register("attention", "paged", _attention_xla, capabilities={"pv_int8": (False,)},
         description="paged KV-cache marker impl: dense invocations (prefill, lockstep) "
         "run the xla pipeline; the continuous engine reads this impl as 'use the "
         "block-pool cache' and decodes through the paged_attention op")


# ---------------------------------------------------------------------------
# paged attention


def _paged_dense_spec(spec: PagedAttentionSpec, impl: str) -> AttentionSpec:
    # ragged valid lengths subsume causality for decode
    return AttentionSpec(impl=impl, softmax=spec.softmax, causal=False,
                         block_k=spec.block_k)


def _make_paged_backend(impl: str, dense_fn):
    """Gather adapter: the dense view of every slot's table (dequantized
    through the scale pages of a quantized pool), then the matching dense
    attention backend over the ragged valid lengths."""

    def fn(spec: PagedAttentionSpec, q, k_pages, v_pages, block_tables, *,
           kv_valid_len, kv_len=None, scale=None, kv_scales=None):
        kd, vd = gather_pages(k_pages, v_pages, block_tables, kv_len, kv_scales)
        return dense_fn(_paged_dense_spec(spec, impl), q, kd, vd,
                        kv_valid_len=kv_valid_len, scale=scale)

    return fn


def _paged_pallas_paged(spec: PagedAttentionSpec, q, k_pages, v_pages,
                        block_tables, *, kv_valid_len, kv_len=None, scale=None,
                        kv_scales=None):
    """Gather-free decode: the kernel walks the block tables in place (and
    dequantizes a quantized pool's pages as it loads them)."""
    if q.shape[1] != 1:
        raise CapabilityError(
            "paged_attention backend 'pallas_paged' is a decode kernel (one query "
            f"token per slot); got Tq={q.shape[1]}"
        )
    valid = kv_valid_len.to(torch.int32)
    if kv_len is not None:
        valid = torch.clamp(valid, max=kv_len)
    k_scale, v_scale = kv_scales if kv_scales is not None else (None, None)
    out = paged_flash_attention(
        q[:, 0], k_pages, v_pages, block_tables, valid,
        fmt=spec.softmax.fmt, sm_scale=scale, k_scale=k_scale, v_scale=v_scale,
    )
    return out[:, None]


_KINDS = ("star", "exact")
register("paged_attention", "reference",
         _make_paged_backend("reference", _attention_reference),
         capabilities={"kv_dtype": KV_DTYPES},
         description="block-table gather (+ dequant) + whole-operand ragged decode")
register("paged_attention", "xla", _make_paged_backend("xla", _attention_xla),
         capabilities={"kv_dtype": KV_DTYPES},
         description="block-table gather (+ dequant) + the online-blocked dense loop")
register("paged_attention", "pallas", _make_paged_backend("pallas", _attention_pallas),
         capabilities={"softmax.kind": _KINDS, "softmax.fault": (None,),
                       "kv_dtype": KV_DTYPES},
         description="block-table gather (+ dequant) + the CUDA flash_star kernel")
register("paged_attention", "pallas_paged", _paged_pallas_paged,
         capabilities={"softmax.kind": _KINDS, "softmax.fault": (None,),
                       "kv_dtype": KV_DTYPES},
         description="gather-free CUDA paged decode kernel, in-kernel dequant of "
         "int8/fp8 pages (kernels.paged_attention)")


def paged_gather_bytes(
    impl: str,
    *,
    table_width: int,
    block_size: int,
    live_lens,
    num_kv_heads: int,
    head_dim: int,
    dtype_bytes: int = 4,
    scale_bytes_per_block: int = 0,
) -> int:
    """Counted K+V bytes one paged decode step reads from the page pool
    (port of the reference's ``ops.paged_gather_bytes``): a traffic model,
    not a measurement.

    The gather adapters (``reference`` / ``xla`` / ``pallas``) materialize
    every slot's whole table window, ``S * W * bs`` rows.  The gather-free
    kernel route ``pallas_paged`` reads only each slot's live pages,
    ``sum(ceil(live / bs)) * bs`` rows (a free slot still counts its one
    clamped page).  ``dtype_bytes`` is the pool leaf's itemsize (1 for
    int8 / fp8 codes); ``scale_bytes_per_block`` adds the K+V scale bytes a
    quantized layout reads per touched block."""
    row_bytes = 2 * num_kv_heads * head_dim * dtype_bytes  # K and V
    lens = [int(x) for x in live_lens]
    if impl == "pallas_paged":
        blocks = sum(max(-(-live // block_size), 1) for live in lens)
    else:
        blocks = len(lens) * table_width
    return blocks * (block_size * row_bytes + scale_bytes_per_block)


# ---------------------------------------------------------------------------
# matmul


def _matmul_xla(spec: MatmulSpec, x, w):
    return torch.matmul(x, w)


def _matmul_hwmodel(spec: MatmulSpec, x, w):
    """``x [M, K] @ w [K, N]`` through the RRAM crossbar model: operands
    quantized and padded, weight-cell faults and per-tile ADC offsets
    injected and the ADC steps calibrated (on the faulty array) in plain
    PyTorch, as the reference does outside its kernel; the tiled ADC
    accumulation is the crossbar kernel."""
    xq, wq, step, offsets, scale = prepare_operands(x, w, spec.crossbar, spec.ranging,
                                                    spec.fault)
    out = crossbar_matmul(xq, wq, step, offsets, spec=spec.crossbar)
    return out[:, :w.shape[1]] * scale


register("matmul", "xla", _matmul_xla, capabilities={"fault": (None,)},
         description="torch.matmul — the performance path")
register("matmul", "hwmodel", _matmul_hwmodel,
         description="RRAM crossbar model: 8-bit operands on 128x128 crossbars through "
         "a 5-bit ADC, CUDA crossbar kernel (kernels.crossbar_matmul)")


# ---------------------------------------------------------------------------
# ssd_scan (the mamba2 mixer's chunk scan)


def _ssd_scan_pallas(spec: ScanSpec, xdt, a, bmat, cmat):
    return ssd_scan(xdt, a, bmat, cmat, chunk=spec.chunk)


def _ssd_scan_reference(spec: ScanSpec, xdt, a, bmat, cmat):
    return ssd_scan_ref(xdt, a, bmat, cmat, chunk=spec.chunk)


register("ssd_scan", "pallas", _ssd_scan_pallas,
         description="CUDA SSD chunk-scan kernel (kernels.ssd_scan)")
register("ssd_scan", "reference", _ssd_scan_reference,
         description="plain chunked SSD (models.ssm via kernels.ssd_scan.ref)")
