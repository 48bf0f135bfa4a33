"""flash_star — fused attention with the STAR online softmax, the wrapper of
the CUDA C++ kernel ``csrc/flash_star.cu`` (port of
``repro.kernels.flash_star.kernel.flash_star_attention``).

Heads-major layout as in the reference: q ``[B, Hq, Tq, D]``, k/v
``[B, Hkv, Tk, D]``, ``info`` int32 ``[1 + B]`` = ``[q_offset, kv_valid…]``.
Any strides are taken as long as the feature dimension is contiguous, so
the ops layer passes transposed views without a copy.  On a CPU tensor the
plain version (``ref.flash_star_ref``) runs instead.

``block_k`` is the KV block of the plain version's loop; the CUDA kernel
uses its own fixed tiles (64 q rows, 32 KV rows), which changes only the
float summation order.  ``pv_int8=True`` runs the int8 P.V variant, whose
codes depend on the block: there the KV block is ``min(block_k, Tk)`` rows
in the kernel too (at most ``PV_INT8_MAX_BLOCK``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_star.ref import flash_star_ref

SOURCE = Path(__file__).parent / "csrc" / "flash_star.cu"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PV_INT8_MAX_BLOCK = 128  # the kernel's BK8
LAUNCHES = _cuda.launch_counter("flash_star")
PV_INT8_LAUNCHES = _cuda.launch_counter("flash_star_pv_int8")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.flash_star_launch.argtypes = (
        [p] * 6 + [ll] * 12 + [i] * 7 + [i, i, f, f, i, i, p]
    )
    lib.flash_star_launch.restype = i


def flash_star_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    info: torch.Tensor,
    *,
    fmt: Optional[FixedPointFormat],  # None -> exact softmax
    causal: bool = True,
    sliding_window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    block_k: int = 128,
    pv_int8: bool = False,
) -> torch.Tensor:
    """Fused attention.  Returns ``[B, Hq, Tq, D]`` in q's dtype."""
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {q.shape[1]} % {k.shape[1]}")
    if block_k <= 0:
        raise ValueError(f"block_k must be > 0, got {block_k}")
    if not _cuda.on_card(q):
        return flash_star_ref(
            q, k, v, info, fmt=fmt, causal=causal, sliding_window=sliding_window,
            sm_scale=sm_scale, block_k=block_k, pv_int8=pv_int8,
        )
    bk = 0
    if pv_int8:
        bk = max(1, min(block_k, k.shape[2]))
        if bk > PV_INT8_MAX_BLOCK:
            raise ValueError(f"flash_star pv_int8 kernel takes KV blocks of at most "
                             f"{PV_INT8_MAX_BLOCK} rows, got block_k={block_k}")
    return _launch(q, k, v, info, fmt, causal, sliding_window, sm_scale, bk)


def _launch(q, k, v, info, fmt, causal, sliding_window, sm_scale, bk) -> torch.Tensor:
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_star kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_star kernel takes float32/bfloat16 q/k/v of one type, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("info", info)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_star kernel needs a contiguous feature dimension")
    if info.dtype != torch.int32 or info.shape != (1 + b,) or not info.is_contiguous():
        raise ValueError(f"info must be contiguous int32 [1 + B], got {info.dtype} {tuple(info.shape)}")
    out = torch.empty((b, hq, tq, d), dtype=q.dtype, device=q.device)
    lut = _cuda.device_lut(fmt, q.device) if fmt is not None else None
    lib = _cuda.load(SOURCE, _bind)
    rc = lib.flash_star_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        info.data_ptr(), lut.data_ptr() if lut is not None else None,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, hq, hkv, tq, tk, d, DTYPES[q.dtype],
        int(causal), int(sliding_window or 0),
        float(d ** -0.5 if sm_scale is None else sm_scale),
        float(fmt.scale) if fmt is not None else 1.0,
        fmt.num_levels if fmt is not None else 0, bk,
        _cuda.stream_handle(q.device),
    )
    _cuda.check(lib, rc, "flash_star")
    (PV_INT8_LAUNCHES if bk else LAUNCHES).add()
    return out
