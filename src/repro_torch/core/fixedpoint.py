"""Fixed-point formats for the STAR softmax codebook (port of
``repro.core.fixedpoint``).

A nonpositive value ``z`` maps to the codebook index
``k = round(-z * 2**frac_bits)`` clipped to ``num_levels - 1``; logits snap
onto the signed integer grid ``round(x * scale)`` before the row max, so max
search and subtraction are exact integer operations.

Rounding is half to even (``torch.round``), as ``jnp.round`` is.
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
