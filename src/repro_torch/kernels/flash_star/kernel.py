"""flash_star — fused attention with the STAR online softmax, the wrapper of
the CUDA C++ kernel ``csrc/flash_star.cu`` (port of
``repro.kernels.flash_star.kernel.flash_star_attention``).

Heads-major layout as in the reference: q ``[B, Hq, Tq, D]``, k/v
``[B, Hkv, Tk, D]``, ``info`` int32 ``[1 + B]`` = ``[q_offset, kv_valid…]``.
Any strides are taken as long as the feature dimension is contiguous, so
the ops layer passes transposed views without a copy.  On a CPU tensor the
plain version (``ref.flash_star_ref``) runs instead.

The kernel is chosen by type, a documented choice and no fallback:
bfloat16 runs on the tensor cores (``flash_star_mma_launch``: mma.sync,
P.V with P in three bf16 pieces, so P keeps its float32 value), float32 on
the FP32 FMA kernel, and ``pv_int8=True`` on the int8 P.V kernel, either
type.  The bfloat16 kernel copies 16-byte pieces, so its q/k/v must start
on a 16-byte boundary with batch, head and T strides of 16 bytes each; a
view that does not is refused with a ValueError before any launch (the
ops layer's transposed ``[B, T, H, D]`` views pass).

``block_k`` is the KV block of the plain version's loop; the CUDA kernels
use their own fixed tiles (64 q rows; 64 KV rows in bf16, 32 in float32),
which changes only the float summation order.  ``pv_int8=True`` runs the
int8 P.V variant, whose codes depend on the block: there the KV block is
``min(block_k, Tk)`` rows in the kernel too (at most ``PV_INT8_MAX_BLOCK``).
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
    lib.flash_star_mma_launch.argtypes = [p] * 6 + [ll] * 12 + [i] * 6 + [i, i, f, f, i, p]
    lib.flash_star_mma_launch.restype = i


def _check_16_byte_pieces(name: str, t: torch.Tensor, ptr: int, strides) -> None:
    """The bf16 kernel's ``cp.async`` copies 16 bytes at a time: refuse a
    base pointer or a batch / head / T stride (of a dimension longer than
    1) that is not a multiple of 16 bytes (8 bf16 elements)."""
    shape = t.shape
    if ptr % 16 == 0 and all(st % 8 == 0 or n == 1 for st, n in zip(strides[:3], shape)):
        return
    bad = [f"data_ptr % 16 = {ptr % 16}"] if ptr % 16 else []
    bad += [f"stride({i}) = {st} elements" for i, st in enumerate(strides[:3])
            if shape[i] > 1 and st % 8]
    raise ValueError(
        f"flash_star's bf16 tensor-core kernel needs 16-byte aligned {name}: "
        f"{', '.join(bad)} (shape {tuple(shape)}); pass a contiguous copy")


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
    dtype = q.dtype
    if dtype not in DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"flash_star kernel takes float32/bfloat16 q/k/v of one type, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    dev = q.device
    if not dev == k.device == v.device == info.device:
        for name, t in (("k", k), ("v", v), ("info", info)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, q on {dev}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("flash_star kernel needs a contiguous feature dimension")
    if info.dtype != torch.int32 or info.shape != (1 + b,) or not info.is_contiguous():
        raise ValueError(f"info must be contiguous int32 [1 + B], got {info.dtype} {tuple(info.shape)}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    mma = dtype == torch.bfloat16 and not bk
    if mma:
        for name, t, ptr, st in (("q", q, ptrs[0], qs), ("k", k, ptrs[1], ks), ("v", v, ptrs[2], vs)):
            _check_16_byte_pieces(name, t, ptr, st)
    out = torch.empty((b, hq, tq, d), dtype=dtype, device=dev)
    lut = _cuda.device_lut(fmt, dev) if fmt is not None else None
    lib = _cuda.load(SOURCE, _bind)
    args = (
        *ptrs, out.data_ptr(), info.data_ptr(), lut.data_ptr() if lut is not None else None,
        *qs[:3], *ks[:3], *vs[:3], *out.stride()[:3],
        b, hq, hkv, tq, tk, d,
    )
    softmax = (
        int(causal), int(sliding_window or 0),
        float(d ** -0.5 if sm_scale is None else sm_scale),
        float(fmt.scale) if fmt is not None else 1.0,
        fmt.num_levels if fmt is not None else 0,
    )
    stream = _cuda.stream_handle(dev)
    if mma:
        rc = lib.flash_star_mma_launch(*args, *softmax, stream)
    else:
        rc = lib.flash_star_launch(*args, DTYPES[dtype], *softmax, bk, stream)
    _cuda.check(lib, rc, "flash_star")
    (PV_INT8_LAUNCHES if bk else LAUNCHES).add()
    return out
