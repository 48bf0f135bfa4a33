"""Exponential lookup tables — the LUT / VMM crossbar contents (port of
``repro.core.lut``).

``lut[k] = exp(-k / 2**frac_bits)`` is computed in float64 with numpy and
rounded once to float32, exactly as the reference does, so a gathered entry
is bit-identical to the reference's.  The Hopper kernels read the same table.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.fixedpoint import FixedPointFormat


@functools.lru_cache(maxsize=64)
def _exp_lut_np(int_bits: int, frac_bits: int) -> np.ndarray:
    fmt = FixedPointFormat(int_bits, frac_bits)
    k = np.arange(fmt.num_levels, dtype=np.float64)
    return np.exp(-k / fmt.scale).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _exp_lut_on(int_bits: int, frac_bits: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    table = torch.from_numpy(_exp_lut_np(int_bits, frac_bits))
    return table.to(device=device, dtype=dtype)


def exp_lut(fmt: FixedPointFormat, device=None, dtype=torch.float32) -> torch.Tensor:
    """``lut[k] = exp(-k / 2**frac_bits)``, shape ``[num_levels]``.

    One copy per (format, device, dtype), shared by every caller, who only
    read it: an upload per call would be a host-to-device copy inside each
    STAR softmax, which a CUDA graph cannot capture."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _exp_lut_on(fmt.int_bits, fmt.frac_bits, str(dev), dtype)


def clamp_is_negligible(fmt: FixedPointFormat, rows: int) -> bool:
    """Whether an online softmax over ``rows`` keys gives the same result,
    to float32 rounding, under any block schedule.

    The online form rescales by ``lut[min(shift, top)]`` and takes each p
    as ``lut[min(m - j, top)]``, with ``top = num_levels - 1``: the product
    of two entries equals the entry of the summed index only while that sum
    stays within ``top``, where the table clamps.  Past it a key's weight
    depends on the schedule, by at most ``lut[top]``, so the output by at
    most ``rows * lut[top]`` of it (the denominator is at least 1).  True
    when that is under 2^-24: at 6 bits (5i.1f) and up for any realistic
    ``rows``, never at 2 to 5 bits, whose last entry is e^-1.5 .. e^-15.5.
    The kernels choose their block route by it, on the host, from the
    format and the shapes alone."""
    top = float(_exp_lut_np(fmt.int_bits, fmt.frac_bits)[-1])
    return rows * top < 2.0 ** -24


def exp_lut_int(fmt: FixedPointFormat, out_bits: int = 8, device=None) -> torch.Tensor:
    """Integer-mantissa LUT of the int8 P.V path:
    ``round(exp(-k / scale) * (2**(out_bits - 1) - 1))`` as int8, rounded in
    numpy from the float32 table as the reference does."""
    if not 2 <= out_bits <= 8:
        raise ValueError("out_bits must be in [2, 8]")
    top = (1 << (out_bits - 1)) - 1
    vals = _exp_lut_np(fmt.int_bits, fmt.frac_bits)
    return torch.from_numpy(np.round(vals * top).astype(np.int8)).to(
        device if device is not None else "cpu")


def int_lut_scale(out_bits: int = 8) -> float:
    """Dequantization scale of :func:`exp_lut_int`'s codes."""
    return 1.0 / float((1 << (out_bits - 1)) - 1)


def lookup_gather(k: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Digital shortcut: direct LUT gather."""
    return lut[k.long()]


def lookup_onehot(k: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Faithful crossbar dataflow: ``one_hot(k) @ lut``."""
    onehot = torch.nn.functional.one_hot(k.long(), lut.shape[0]).to(lut.dtype)
    return onehot @ lut


def histogram_counts(
    k: torch.Tensor, num_levels: int, axis: int = -1, weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The counter: ``counts[..., j] = #{i : k[..., i] == j}`` along ``axis``
    (float32), each entry weighted by ``weight`` (a mask of ``k``'s shape)
    when given.

    Counted with ``scatter_add_`` into ``[..., num_levels]``: memory
    ``O(rows * num_levels)``, where the reference's one-hot sum builds
    ``[..., d, num_levels]``.  The counts are exact integers either way."""
    k = torch.movedim(k, axis, -1).long()
    w = torch.ones(k.shape, device=k.device) if weight is None else (
        torch.movedim(weight, axis, -1).float())
    counts = torch.zeros(k.shape[:-1] + (num_levels,), device=k.device)
    return counts.scatter_add_(-1, k, w)


def histogram_dot(counts: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The VMM crossbar: ``sum_j counts[..., j] * lut[j]``."""
    return counts @ lut.to(counts.dtype)
