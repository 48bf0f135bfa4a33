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
from repro_torch.core.star_softmax import Modes
from repro_torch.hwmodel import faults as faults_lib
from repro_torch.hwmodel.faults import FaultModel
from repro_torch.kernels import _cuda
from repro_torch.kernels.star_softmax.ref import (  # noqa: F401
    CLUSTER_MAX, NT, SLICE_ALIGN, SLICE_TARGET, WARP, cluster_size, exact_softmax_ref,
    kernel_order_dot, kernel_order_sum, slice_len, star_softmax_ref)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the codes of the CUDA entry point
LAUNCHES = _cuda.launch_counter("star_softmax")
LUT_SOURCE = Path(__file__).parent / "csrc" / "star_softmax_lut.cu"
LUT_LAUNCHES = _cuda.launch_counter("star_softmax_lut")
MAX_LEVELS = 4096  # three tables and the counters in shared memory: 16 L bytes


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
