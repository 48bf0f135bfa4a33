"""STAR softmax — the paper's softmax engine on tensors (port of
``repro.core.star_softmax``).

Pipeline: snap logits to the integer grid, integer row max, codebook index
``k = clip(m - j)``, numerators from the LUT (``gather`` or ``onehot``),
denominator as a row sum or ``histogram(k) @ lut`` (``histogram`` mode).
The three modes agree up to float summation order.

``fault`` injects a seeded :class:`~repro_torch.hwmodel.faults.FaultModel`
into the arrays each stage reads: the CAM match (broken rows remap to the
nearest working row), the numerator LUT, and in ``histogram`` mode the
denominator VMM crossbar (an independent realization of the same contents)
and the shared ADC (a gain on the denominator).  ``gather`` / ``onehot``
sum the faulty numerators digitally, so under faults the modes deliberately
differ, as the hardware paths they model do.

Training: ``star_softmax_ste`` keeps the quantized forward and routes the
gradient through the exact softmax's VJP evaluated at the quantized
probabilities (quantization-aware training), as the reference's
``custom_vjp`` does; a fault perturbs the forward only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.fixedpoint import (
    DEFAULT_FORMAT,
    GRID_SENTINEL,
    FixedPointFormat,
    grid_index,
    quantize_logits,
)
from repro_torch.hwmodel import faults as faults_lib
from repro_torch.hwmodel.faults import FaultModel

Modes = ("gather", "onehot", "histogram")


def exact_softmax(x: torch.Tensor, axis: int = -1, across=None) -> torch.Tensor:
    """The FP oracle (numerically stable softmax).  ``across`` splits the
    row over ranks as in :func:`star_softmax`: the row max is combined with
    ``.max`` and the exponentials' sum with ``.sum``."""
    if across is None:
        return torch.softmax(x, dim=axis)
    e = torch.exp(x - across.max(x.amax(dim=axis, keepdim=True)))
    return e / across.sum(e.sum(dim=axis, keepdim=True))


def star_softmax(
    x: torch.Tensor,
    fmt: FixedPointFormat = DEFAULT_FORMAT,
    *,
    axis: int = -1,
    mode: str = "histogram",
    where: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
    fault: Optional[FaultModel] = None,
    row_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    vmm_dot: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    across=None,
) -> torch.Tensor:
    """Quantized LUT softmax along ``axis``.

    ``where`` masks entries out (probability 0, not counted in the
    denominator); fully masked rows come out as zeros.  ``fault`` injects
    the seeded device non-idealities (``None``: ideal device).  ``row_sum``
    (the numerators ``[..., d]`` -> their sums ``[..., 1]``) fixes the order
    of the ``gather`` / ``onehot`` denominator; default ``sum(-1)``.
    ``vmm_dot`` (counts ``[..., L]``, table ``[L]`` -> ``[...]``) fixes the
    order of the ``histogram`` denominator; default ``counts @ table``.

    ``across`` (with ``.max(t)`` and ``.sum(t)``) splits the row over ranks
    that each hold a slice of the axis: the int32 grid max is combined with
    ``.max`` (exact), and the denominator (``gather`` / ``onehot``) or the
    histogram's integer counts (``histogram``) with ``.sum``, so every rank
    divides its numerators by the whole row's denominator.  Ideal devices
    only: a fault's realization is drawn for the whole row.
    """
    if mode not in Modes:
        raise ValueError(f"mode must be one of {Modes}, got {mode!r}")
    out_dtype = dtype or (x.dtype if x.is_floating_point() else torch.float32)
    faulty = not faults_lib.is_null(fault)
    dev = x.device
    moved = torch.movedim(x.float(), axis, -1)
    wmask = None
    if where is not None:
        wmask = torch.movedim(torch.broadcast_to(where, x.shape), axis, -1)

    j = quantize_logits(moved, fmt)
    if wmask is not None:
        j = torch.where(wmask, j, torch.full_like(j, GRID_SENTINEL))
    m = j.amax(dim=-1, keepdim=True)
    if across is not None:
        if faulty:
            raise ValueError("star_softmax cannot split a faulty row across ranks")
        m = across.max(m)
    k = grid_index(j, m, fmt)

    if faulty:
        remap = faults_lib.cam_remap(fmt, fault, device=dev)
        if remap is not None:
            k = lut_lib.lookup_gather(k, remap)  # broken CAM rows: nearest working row
        table = faults_lib.faulty_exp_lut(fmt, fault, tag="softmax/lut", device=dev)
    else:
        table = lut_lib.exp_lut(fmt, device=dev)
    if mode == "onehot":
        num = lut_lib.lookup_onehot(k, table)
    else:
        num = lut_lib.lookup_gather(k, table)
    if wmask is not None:
        num = torch.where(wmask, num, torch.zeros_like(num))

    if mode == "histogram":
        if wmask is None:
            counts = lut_lib.histogram_counts(k, fmt.num_levels)
        else:
            counts = _weighted_histogram(k, wmask, fmt.num_levels)
        if across is not None:
            counts = across.sum(counts)
        # the denominator VMM crossbar holds its own copy of the LUT contents
        vmm_table = (faults_lib.faulty_exp_lut(fmt, fault, tag="softmax/vmm", device=dev)
                     if faulty else table)
        den = (vmm_dot or lut_lib.histogram_dot)(counts, vmm_table)[..., None]
        if faulty:
            gain = faults_lib.adc_gain(fault)
            if gain is not None:
                den = den * gain
    else:
        den = row_sum(num) if row_sum is not None else num.sum(dim=-1, keepdim=True)
        if across is not None:
            den = across.sum(den)
    den = torch.where(den <= 0.0, torch.ones_like(den), den)
    return torch.movedim(num / den, -1, axis).to(out_dtype)


def _weighted_histogram(k: torch.Tensor, weight_mask: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Counts of ``k`` over the last axis, masked entries not counted."""
    return lut_lib.histogram_counts(k, num_levels, weight=weight_mask)


class _StarSoftmaxSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt, axis, mode, fault, across):
        p = star_softmax(x, fmt, axis=axis, mode=mode, fault=fault, across=across)
        ctx.save_for_backward(p)
        ctx.axis, ctx.across = axis, across
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        inner = (g * p).sum(dim=ctx.axis, keepdim=True)
        if ctx.across is not None:
            inner = ctx.across.sum(inner)
        return (p * (g - inner)).to(g.dtype), None, None, None, None, None


def star_softmax_ste(
    x: torch.Tensor,
    fmt: FixedPointFormat = DEFAULT_FORMAT,
    axis: int = -1,
    mode: str = "histogram",
    fault: Optional[FaultModel] = None,
    across=None,
) -> torch.Tensor:
    """STAR softmax with a straight-through backward: the forward is
    :func:`star_softmax` (with the fault, if any); the backward is
    ``p * (g - sum(g * p))`` at the quantized ``p``, nothing to the fault.
    ``across`` splits the row over ranks, forward and backward."""
    return _StarSoftmaxSTE.apply(x, fmt, axis, mode, fault, across)


def quantization_error(x: torch.Tensor, fmt: FixedPointFormat, *, axis: int = -1,
                       mode: str = "histogram") -> torch.Tensor:
    """Max ``|star_softmax - exact_softmax|`` along ``axis`` (per row)."""
    err = (star_softmax(x, fmt, axis=axis, mode=mode) - exact_softmax(x, axis=axis)).abs()
    return err.amax(dim=axis)
