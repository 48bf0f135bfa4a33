"""STAR row softmax — the wrapper of one Hopper kernel (port of
``repro.kernels.star_softmax.kernel.star_softmax_pallas``).

Softmax over the last axis of ``x`` (any leading shape), float32 output.
Per row: snap to the int grid, integer row max, ``k = clip(m - j, 0, L-1)``,
numerators from the LUT, the denominator as the row sum or, in
``histogram`` mode, as ``counts(k) @ lut``.  Non-finite input saturates as
``core.fixedpoint.quantize_logits`` does, so a ``-inf`` column gets the
last level's probability (the reference semantics), never level 0.

Every mode, clean or faulty, launches the CUDA kernel
``csrc/star_softmax_lut.cu``: a cluster of ``cluster_size(d)`` CTAs owns a
row, each a ``slice_len(d, C)``-column slice, and the row max and the
denominator are reduced through distributed shared memory inside the one
launch.  It takes the numerator LUT, the denominator VMM table and the CAM
remap as runtime tables: a clean call passes ``(lut, lut, identity)``; a
fault passes its seeded realization (``hwmodel.faults``, computed once per
device), and in ``histogram`` mode the output is divided by the ADC gain
afterwards, as the TPU wrapper does.  ``onehot`` is the TPU's one-hot @ LUT
dataflow (``use_mxu_lut``); a one-hot row with a single nonzero reproduces
the gathered entry bit for bit, so it is the gather launch.  Launches count
as ``star_softmax`` (clean ``gather`` / ``onehot``) or ``star_softmax_lut``
(``histogram`` and every faulty call).

On a CPU tensor the plain version (``star_softmax_ref``: the reference
engine ``core.star_softmax`` with the same realization) runs instead.  In
``gather`` / ``onehot`` mode it adds the row's numerators in the kernel's
order (``kernel_order_sum``), so the two agree bit for bit; the histogram
denominator is the engine's own dot.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.core.lut import exp_lut
from repro_torch.core.star_softmax import Modes, star_softmax
from repro_torch.hwmodel import faults as faults_lib
from repro_torch.hwmodel.faults import FaultModel
from repro_torch.kernels import _cuda

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the codes of the CUDA entry point
LAUNCHES = _cuda.launch_counter("star_softmax")
LUT_SOURCE = Path(__file__).parent / "csrc" / "star_softmax_lut.cu"
LUT_LAUNCHES = _cuda.launch_counter("star_softmax_lut")
MAX_LEVELS = 4096  # three tables and the counters in shared memory: 16 L bytes
CLUSTER_MAX = 8  # CTAs a row: the portable cluster size
SLICE_TARGET = 4096  # columns a CTA takes before a row is split over more
SLICE_ALIGN = 8  # slices start on 16 bytes of float32 or bfloat16 x
NT = 256  # the kernel's threads a CTA (``NT`` in the source)
WARP = 32


def cluster_size(d: int) -> int:
    """CTAs of the cluster that owns a row of ``d`` columns: one up to
    ``SLICE_TARGET``, one more per ``SLICE_TARGET``, at most ``CLUSTER_MAX``."""
    return max(1, min(CLUSTER_MAX, -(-d // SLICE_TARGET)))


def slice_len(d: int, cluster: int) -> int:
    """Columns of each CTA's slice: ``d / cluster`` rounded up to
    ``SLICE_ALIGN``; the last slice takes what is left."""
    per_cta = -(-d // cluster)
    return -(-per_cta // SLICE_ALIGN) * SLICE_ALIGN


def kernel_order_sum(p: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
    """Sums over the last axis of ``p`` ``[..., d]`` (float32), keepdim, in
    the order the kernel adds a row's numerators for an input of
    ``x_dtype``: rank ``q`` of the row's cluster takes columns ``[q * slice,
    (q + 1) * slice)``; thread ``t`` of a CTA adds, from 0, the elements
    ``(g * NT + t) * V + e`` of its slice (``V`` of them in 16 bytes of x)
    for ``g``, then ``e``, ascending; a warp adds its lanes' partials by the
    butterfly (lane ``l`` + lane ``l + o`` for ``o`` = 16 .. 1), the CTA its
    warps' the same way, and the row its ranks' partials in rank order,
    from 0.  Every step is one float32 addition, so the result is the
    kernel's on any device."""
    d = p.shape[-1]
    rows = p.reshape(-1, d)
    n = rows.shape[0]
    c = cluster_size(d)
    s = slice_len(d, c)
    v = 16 // x_dtype.itemsize if x_dtype in DTYPES else 4
    span = NT * v
    groups = -(-s // span)
    sliced = torch.nn.functional.pad(rows, (0, c * s - d)).reshape(n, c, s)
    t = torch.nn.functional.pad(sliced, (0, groups * span - s)).reshape(n, c, groups, NT, v)
    part = torch.zeros((n, c, NT), dtype=p.dtype, device=p.device)
    for g in range(groups):
        for e in range(v):
            part = part + t[:, :, g, :, e]
    warps = _block_sum(part)
    den = torch.zeros((n,), dtype=p.dtype, device=p.device)
    for q in range(c):
        den = den + warps[:, q]
    return den.reshape(p.shape[:-1] + (1,))


def _block_sum(part: torch.Tensor) -> torch.Tensor:
    """The kernel's ``block_sum`` of ``[..., NT]`` thread partials: a warp
    adds its lanes by the butterfly (lane ``l`` + lane ``l + o``, ``o`` = 16
    .. 1), then the warps' sums the same way.  ``[...]``."""
    lanes = part.reshape(part.shape[:-1] + (NT // WARP, WARP))
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    warps = lanes[..., 0]
    o = NT // WARP // 2
    while o:
        warps = warps[..., :o] + warps[..., o:2 * o]
        o //= 2
    return warps[..., 0]


def kernel_order_dot(counts: torch.Tensor, vmm: torch.Tensor) -> torch.Tensor:
    """The histogram mode's denominator ``sum_l counts[..., l] * vmm[l]``
    (float32 ``[...]``) in the kernel's order: thread ``t`` adds, from 0, the
    rounded products of levels ``t, t + NT, ...`` ascending, then
    ``block_sum``.  Every CTA of the cluster forms it alike from the
    cluster's summed counts, so it is the kernel's on any device."""
    levels = counts.shape[-1]
    prod = counts.float() * vmm.float()
    rounds = -(-levels // NT)
    prod = torch.nn.functional.pad(prod, (0, rounds * NT - levels))
    prod = prod.reshape(prod.shape[:-1] + (rounds, NT))
    part = torch.zeros(prod.shape[:-2] + (NT,), dtype=torch.float32, device=prod.device)
    for r in range(rounds):
        part = part + prod[..., r, :]
    return _block_sum(part)


def star_softmax_ref(x: torch.Tensor, fmt: FixedPointFormat, *, mode: str = "gather",
                     fault: Optional[FaultModel] = None) -> torch.Tensor:
    """The plain version of the kernel: the reference engine, the row sum
    of ``gather`` / ``onehot`` mode and the ``histogram`` mode's VMM dot
    taken in the kernel's order (so a clean call is bit for bit the
    kernel's; a faulty histogram divides by the ADC gain before the row
    where the kernel's wrapper divides after it: an ulp)."""
    return star_softmax(x, fmt, mode=mode, fault=fault, dtype=torch.float32,
                        row_sum=lambda num: kernel_order_sum(num, x.dtype),
                        vmm_dot=kernel_order_dot)


def star_softmax_kernel(
    x: torch.Tensor, fmt: FixedPointFormat, *, mode: str = "gather",
    fault: Optional[FaultModel] = None,
) -> torch.Tensor:
    """STAR softmax over the last axis; float32 ``[..., d]``.  Raises
    ``KernelGradError`` where autograd would differentiate it."""
    _cuda.refuse_grad("star_softmax_kernel", x)
    if mode not in Modes:
        raise ValueError(f"mode must be one of {Modes}, got {mode!r}")
    if not _cuda.on_card(x):
        return star_softmax_ref(x, fmt, mode=mode, fault=fault)
    return _launch(_rows(x), fmt, mode, fault).reshape(x.shape)


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in DTYPES:
        raise ValueError(f"star_softmax kernel takes float32/bfloat16, got {x.dtype}")
    if x.ndim == 0 or x.shape[-1] == 0:
        raise ValueError(f"star_softmax kernel needs a non-empty last axis, got {tuple(x.shape)}")
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(1) != 1:
        raise ValueError("star_softmax kernel needs a contiguous last axis")
    return x2


@functools.lru_cache(maxsize=16)
def _identity(levels: int, device: str) -> torch.Tensor:
    return torch.arange(levels, dtype=torch.int32, device=device)


def _tables(fmt: FixedPointFormat, mode: str, fault: Optional[FaultModel], device):
    """(lut, vmm, remap) for the kernel, all on ``device``."""
    if faults_lib.is_null(fault):
        lut = exp_lut(fmt, device=device)
        return lut, lut, _identity(fmt.num_levels, str(device))
    lut = faults_lib.faulty_exp_lut(fmt, fault, "softmax/lut", device=device)
    vmm = (faults_lib.faulty_exp_lut(fmt, fault, "softmax/vmm", device=device)
           if mode == "histogram" else lut)
    remap = faults_lib.cam_remap(fmt, fault, device=device)
    if remap is None:
        remap = _identity(fmt.num_levels, str(device))
    return lut, vmm, remap


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.star_softmax_lut_launch.argtypes = [p] * 5 + [i, i, i, i, ll, ll, i, i, f, i, p]
    lib.star_softmax_lut_launch.restype = i


def _launch(x2: torch.Tensor, fmt: FixedPointFormat, mode: str,
            fault: Optional[FaultModel]) -> torch.Tensor:
    levels = fmt.num_levels
    if levels > MAX_LEVELS:
        raise ValueError(f"star_softmax kernel holds at most {MAX_LEVELS} levels in "
                         f"shared memory; format {fmt.short_name()} has {levels}")
    lut, vmm, remap = _tables(fmt, mode, fault, x2.device)
    histogram = mode == "histogram"
    clean_gather = faults_lib.is_null(fault) and not histogram
    rows, d = x2.shape
    out = torch.empty((rows, d), dtype=torch.float32, device=x2.device)
    if rows == 0:
        return out
    cluster = cluster_size(d)
    lib = _cuda.load(LUT_SOURCE, _bind)
    rc = lib.star_softmax_lut_launch(
        x2.data_ptr(), out.data_ptr(), lut.data_ptr(), vmm.data_ptr(), remap.data_ptr(),
        rows, d, cluster, slice_len(d, cluster), x2.stride(0), out.stride(0),
        DTYPES[x2.dtype], int(histogram), float(fmt.scale), levels,
        _cuda.stream_handle(x2.device),
    )
    _cuda.check(lib, rc, "star_softmax")
    (LAUNCHES if clean_gather else LUT_LAUNCHES).add()
    if histogram and not faults_lib.is_null(fault):
        gain = faults_lib.adc_gain(fault)
        if gain is not None:
            out = out / gain  # den * gain, hoisted out of the kernel as on the TPU
    return out
