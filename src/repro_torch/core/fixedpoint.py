"""Fixed-point formats for the STAR softmax codebook (port of
``repro.core.fixedpoint``).

A nonpositive value ``z`` maps to the codebook index
``k = round(-z * 2**frac_bits)`` clipped to ``num_levels - 1``; logits snap
onto the signed integer grid ``round(x * scale)`` before the row max, so max
search and subtraction are exact integer operations.

Rounding is half to even (``torch.round``), as ``jnp.round`` is.

``quantize_value_ste`` is the codebook round-trip for quantization-aware
training: its backward passes the gradient inside the clip range and zeroes
it outside, as the reference's ``custom_vjp`` does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """Unsigned fixed-point format for nonpositive inputs (sign dropped).

    Represents the codebook ``{-k / 2**frac_bits : k = 0 .. 2**bits - 1}``.
    """

    int_bits: int
    frac_bits: int

    def __post_init__(self) -> None:
        if self.int_bits < 0 or self.frac_bits < 0:
            raise ValueError("bit counts must be nonnegative")
        if self.total_bits <= 0:
            raise ValueError("format must have at least one bit")
        if self.total_bits > 16:
            raise ValueError(
                "codebooks beyond 16 bits defeat the purpose of STAR "
                f"(got {self.total_bits} bits)"
            )

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def num_levels(self) -> int:
        return 1 << self.total_bits

    @property
    def scale(self) -> float:
        """Levels per unit: index k represents -k / scale."""
        return float(1 << self.frac_bits)

    @property
    def min_value(self) -> float:
        return -(self.num_levels - 1) / self.scale

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    def short_name(self) -> str:
        return f"u{self.total_bits}({self.int_bits}i.{self.frac_bits}f)"


# Paper's per-dataset formats (Section II).
FORMAT_CNEWS = FixedPointFormat(int_bits=6, frac_bits=2)  # 8 bits
FORMAT_MRPC = FixedPointFormat(int_bits=6, frac_bits=3)  # 9 bits
FORMAT_COLA = FixedPointFormat(int_bits=5, frac_bits=2)  # 7 bits

DEFAULT_FORMAT = FORMAT_CNEWS

# Sentinel for masked / -inf logits on the integer grid: deep enough that
# (max - sentinel) always clips to the last LUT level, small enough that
# int32 arithmetic never overflows.
GRID_SENTINEL = -(1 << 24)


def quantize_logits(x: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Snap logits onto the signed grid: ``round(x * scale)`` as int32.

    NaN maps to ``GRID_SENTINEL`` and the result saturates at
    ``±GRID_SENTINEL`` before the int cast, so ``-inf`` lands on the last
    codebook level instead of wrapping.
    """
    j = torch.round(x.float() * fmt.scale)
    j = torch.nan_to_num(j, nan=float(GRID_SENTINEL))
    j = torch.clamp(j, float(GRID_SENTINEL), float(-GRID_SENTINEL))
    return j.to(torch.int32)


def grid_index(j: torch.Tensor, m: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Codebook index ``k = clip(m - j, 0, num_levels - 1)`` (int32)."""
    return torch.clamp(m - j, 0, fmt.num_levels - 1)


def quantize_index(z: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Nonpositive values ``z`` as codebook indices
    ``clip(round(-z * scale), 0, num_levels - 1)``: a positive input clamps
    to 0, one below ``min_value`` to the last level, NaN to the last level.
    uint8 up to 256 levels, else int32 (the reference's uint16: the same
    values, in a type every torch operator takes)."""
    scaled = torch.round(-z.float() * fmt.scale)
    scaled = torch.nan_to_num(scaled, nan=float(fmt.num_levels - 1))
    scaled = torch.clamp(scaled, 0.0, float(fmt.num_levels - 1))
    return scaled.to(torch.uint8 if fmt.num_levels <= 256 else torch.int32)


def dequantize(k: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Codebook value of index ``k``: ``-k / scale`` (float32)."""
    return -(k.float()) / fmt.scale


def quantize_value(z: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Round-trip ``z`` through the codebook (quantize, then dequantize)."""
    return dequantize(quantize_index(z, fmt), fmt)


class _QuantizeValueSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, fmt):
        ctx.save_for_backward(z)
        ctx.fmt = fmt
        return quantize_value(z, fmt)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        in_range = (z <= 0.0) & (z >= ctx.fmt.min_value)
        return torch.where(in_range, g, torch.zeros_like(g)).to(g.dtype), None


def quantize_value_ste(z: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Straight-through round-trip: forward :func:`quantize_value`, backward
    the identity where ``min_value <= z <= 0`` and zero outside."""
    return _QuantizeValueSTE.apply(z, fmt)
