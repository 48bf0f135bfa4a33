"""flash_star — fused attention with the STAR online softmax, the wrapper of
the CUDA C++ kernel ``csrc/flash_star.cu`` (port of
``repro.kernels.flash_star.kernel.flash_star_attention``).

Heads-major layout as in the reference: q ``[B, Hq, Tq, D]``, k/v
``[B, Hkv, Tk, D]``, ``info`` int32 ``[1 + B]`` = ``[q_offset, kv_valid…]``.
Any strides are taken as long as the feature dimension is contiguous, so
the ops layer passes transposed views without a copy.  On a CPU tensor the
plain version (``ref.flash_star_ref``) runs instead.

The kernel is chosen by type and variant, a documented choice and no
fallback, every one on the tensor cores: bfloat16 on
``flash_star_mma_launch`` (mma.sync, P.V with P in three bf16 pieces, so P
keeps its float32 value), float32 on ``flash_star_tf32_launch`` (every
product as 3xTF32), and ``pv_int8=True``, either type, as two launches
behind one call and one ``flash_star_pv_int8`` count: V's int8 codes once
per block into a workspace sized from the shapes
(``flash_star_quantize_v_launch``), then the attention with an s8 P.V
(``flash_star_pv_int8_launch``).  Every kernel copies 16-byte pieces, so
q/k/v must start on a 16-byte boundary with batch, head and T strides of
16 bytes each; a view that does not is refused with a ValueError before
any launch (the ops layer's transposed ``[B, T, H, D]`` views pass).

Head dims ``HEAD_DIMS``: 8, 16, 32, 64, 128 and 256 (recurrentgemma-2b), on
every kernel.  At 8 the bf16 products still take k in steps of 16: the
kernels zero-fill Q and K to 16 columns in shared memory, and ``sm_scale``
keeps the true D, so every score is the 8-term dot (a bf16 row of 8 is one
16-byte piece).

``block_k`` is the KV block of the TPU kernel and of the plain version's
loop.  Under STAR the result depends on it: the online rescale
``lut[a] * lut[b] == lut[a + b]`` fails once ``a + b`` passes the table's
deepest level, where it clamps.  Where that can move the output by no more
than float32 rounding (``core.lut.clamp_is_negligible``: formats of 6 bits
(5i.1f) and up, and the exact softmax) the one-pass kernels walk their own
fixed tiles (64 q rows, 32 at D 256 in the float32 and int8 P.V kernels;
64 KV rows in bf16, 32 at D 256; 32 in float32, 16 at D 256), which
changes only the float summation order.  At 2 to 5 bits a STAR call takes
the block route instead, ``flash_star_blocked_launch`` (either type; its
own count ``flash_star_blocked``): KV blocks of ``min(block_k, Tk)`` rows
from row 0 as in the TPU kernel, each walked twice, its max first, then P
against it.  The route is chosen here from the format and Tk alone, never
from values on the card (a decode tick is a CUDA graph replay): both
routes are the kernel.  ``pv_int8=True`` runs the int8 P.V variant, whose
codes depend on the block: there the KV block is ``min(block_k, Tk)`` rows
at every format, of any size (the same two passes).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.core.lut import clamp_is_negligible, exp_lut
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_star.ref import V8_GROUP, flash_star_ref

SOURCE = Path(__file__).parent / "csrc" / "flash_star.cu"
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = _cuda.launch_counter("flash_star")
PV_INT8_LAUNCHES = _cuda.launch_counter("flash_star_pv_int8")
BLOCKED_LAUNCHES = _cuda.launch_counter("flash_star_blocked")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    args = [p] * 6 + [ll] * 12 + [i] * 6
    softmax = [i, i, f, f, i]
    lib.flash_star_mma_launch.argtypes = args + softmax + [p]
    lib.flash_star_tf32_launch.argtypes = args + softmax + [p]
    lib.flash_star_quantize_v_launch.argtypes = [p] + [ll] * 3 + [i] * 6 + [p, p, p]
    lib.flash_star_pv_int8_launch.argtypes = args + [i] + softmax + [i, p, p, p]
    lib.flash_star_blocked_launch.argtypes = args + [i] + softmax + [i, p]
    for fn in (lib.flash_star_mma_launch, lib.flash_star_tf32_launch,
               lib.flash_star_quantize_v_launch, lib.flash_star_pv_int8_launch,
               lib.flash_star_blocked_launch):
        fn.restype = i


def _check_16_byte_pieces(name: str, t: torch.Tensor, ptr: int, strides) -> None:
    """The kernels' ``cp.async`` copies 16 bytes at a time: refuse a base
    pointer or a batch / head / T stride (of a dimension longer than 1) that
    is not a multiple of 16 bytes."""
    shape, per = t.shape, 16 // t.element_size()
    if ptr % 16 == 0 and all(st % per == 0 or n == 1 for st, n in zip(strides[:3], shape)):
        return
    bad = [f"data_ptr % 16 = {ptr % 16}"] if ptr % 16 else []
    bad += [f"stride({i}) = {st} elements" for i, st in enumerate(strides[:3])
            if shape[i] > 1 and st % per]
    raise ValueError(
        f"flash_star's tensor-core kernels need 16-byte aligned {name}: "
        f"{', '.join(bad)} (shape {tuple(shape)}); pass a contiguous copy")


def v8_shape(b: int, hkv: int, tk: int, d: int, bk: int):
    """The int8 variant's workspace: codes ``[B, Hkv, nblk, D, kpad]`` and
    scales ``[B, Hkv, nblk]``, ``nblk = ceil(Tk / bk)`` blocks of ``bk``
    rows, each feature's codes padded to ``kpad`` (a multiple of 32)."""
    nblk = -(-tk // bk)
    kpad = -(-bk // V8_GROUP) * V8_GROUP
    return (b, hkv, nblk, d, kpad), (b, hkv, nblk)


def _quantize_v(lib, v: torch.Tensor, bk: int, stream: int):
    """V's codes and scales on the card (``ref.quantize_v_blocks`` and
    ``ref.v8_layout`` are the plain version): one launch."""
    b, hkv, tk, d = v.shape
    code_shape, scale_shape = v8_shape(b, hkv, tk, d, bk)
    codes = torch.empty(code_shape, dtype=torch.int8, device=v.device)
    scales = torch.empty(scale_shape, dtype=torch.float32, device=v.device)
    rc = lib.flash_star_quantize_v_launch(
        v.data_ptr(), *v.stride()[:3], b, hkv, tk, d, DTYPES[v.dtype], bk,
        codes.data_ptr(), scales.data_ptr(), stream)
    _cuda.check(lib, rc, "flash_star_quantize_v")
    return codes, scales


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
    """Fused attention.  Returns ``[B, Hq, Tq, D]`` in q's dtype.  Raises
    ``KernelGradError`` where autograd would differentiate it."""
    _cuda.refuse_grad("flash_star_attention", q, k, v)
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {q.shape[1]} % {k.shape[1]}")
    if block_k <= 0:
        raise ValueError(f"block_k must be > 0, got {block_k}")
    if not _cuda.on_card(q):
        return flash_star_ref(
            q, k, v, info, fmt=fmt, causal=causal, sliding_window=sliding_window,
            sm_scale=sm_scale, block_k=block_k, pv_int8=pv_int8,
        )
    bk = max(1, min(block_k, k.shape[2]))
    return _launch(q, k, v, info, fmt, causal, sliding_window, sm_scale, bk, pv_int8,
                   blocked=fmt is not None and not clamp_is_negligible(fmt, k.shape[2]))


def _launch(q, k, v, info, fmt, causal, sliding_window, sm_scale, bk, pv_int8,
            blocked) -> torch.Tensor:
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
    for name, t, ptr, st in (("q", q, ptrs[0], qs), ("k", k, ptrs[1], ks), ("v", v, ptrs[2], vs)):
        _check_16_byte_pieces(name, t, ptr, st)
    out = torch.empty((b, hq, tq, d), dtype=dtype, device=dev)
    lut = exp_lut(fmt, device=dev) if fmt is not None else None
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
    if pv_int8:
        codes, scales = _quantize_v(lib, v, bk, stream)
        rc = lib.flash_star_pv_int8_launch(*args, DTYPES[dtype], *softmax, bk,
                                           codes.data_ptr(), scales.data_ptr(), stream)
        _cuda.check(lib, rc, "flash_star_pv_int8")
        PV_INT8_LAUNCHES.add()
        return out
    if blocked:
        rc = lib.flash_star_blocked_launch(*args, DTYPES[dtype], *softmax, bk, stream)
        _cuda.check(lib, rc, "flash_star_blocked")
        BLOCKED_LAUNCHES.add()
        return out
    launch = lib.flash_star_mma_launch if dtype == torch.bfloat16 else lib.flash_star_tf32_launch
    _cuda.check(lib, launch(*args, *softmax, stream), "flash_star")
    LAUNCHES.add()
    return out
