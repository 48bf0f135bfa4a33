"""Device non-ideality models for the RRAM crossbar engines (port of
``repro.hwmodel.faults``).

A :class:`FaultModel` is a frozen, hashable description of one seeded
realization: conductance variation (lognormal), stuck-at-G_on / G_off cells,
ADC input offsets and accumulated read disturb.  The seed plus a per-site tag
determine every mask and noise draw through explicit keys
(:func:`fault_key`), drawn with the port's copy of ``jax.random``
(:mod:`repro_torch.hwmodel.prng`), so the port injects the reference's
realization: stuck masks and CAM remaps bit for bit, normal-derived values
(variation, ADC gain and offsets) within a few float32 ulps.

Site tags (one realization per physical array): ``softmax/lut``,
``softmax/vmm``, ``softmax/cam``, ``softmax/adc``, ``matmul/w``,
``matmul/adc``.

A realization is a pure function of ``(fault, tag, shape)``.  The reference
computes it under ``jit``, once per compilation; the port runs eagerly, so
each realization is computed once per device and cached (the cached tensors
are shared: callers must not modify them).
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Optional, Tuple

import torch

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.hwmodel import prng

_CACHE = 64


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """One seeded realization of device non-idealities.

    All rates and sigmas default to zero, so ``FaultModel()`` is the ideal
    device (:attr:`is_null`); specs treat ``fault=None`` and a null model
    alike.
    """

    g_sigma: float = 0.0  # lognormal conductance variation (sigma of ln G)
    stuck_on_rate: float = 0.0  # P(cell stuck at G_on): reads as the max value
    stuck_off_rate: float = 0.0  # P(cell stuck at G_off): reads as zero
    adc_offset_sigma: float = 0.0  # ADC input offset, in LSB of the ADC step
    read_disturb: float = 0.0  # accumulated drift: G *= exp(-read_disturb)
    seed: int = 0  # realization seed: explicit keys derive from it

    def __post_init__(self) -> None:
        for f in ("g_sigma", "adc_offset_sigma", "read_disturb"):
            if getattr(self, f) < 0.0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")
        for f in ("stuck_on_rate", "stuck_off_rate"):
            if not 0.0 <= getattr(self, f) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {getattr(self, f)}")
        if self.stuck_on_rate + self.stuck_off_rate > 1.0:
            raise ValueError(
                "stuck_on_rate + stuck_off_rate must be <= 1, got "
                f"{self.stuck_on_rate} + {self.stuck_off_rate}"
            )

    @property
    def is_null(self) -> bool:
        """True when every non-ideality is switched off (the ideal device)."""
        return (
            self.g_sigma == 0.0
            and self.stuck_on_rate == 0.0
            and self.stuck_off_rate == 0.0
            and self.adc_offset_sigma == 0.0
            and self.read_disturb == 0.0
        )

    @property
    def stuck_rate(self) -> float:
        return self.stuck_on_rate + self.stuck_off_rate

    @classmethod
    def after_reads(cls, reads: int, disturb_per_read: float, **kwargs) -> "FaultModel":
        """``reads`` accumulated read-disturb events at a per-read drift rate
        (first order: drifts compose multiplicatively)."""
        return cls(read_disturb=disturb_per_read * reads, **kwargs)


def is_null(fault: Optional[FaultModel]) -> bool:
    """``None`` and the all-zero model both mean "ideal device"."""
    return fault is None or fault.is_null


def fault_key(fault: FaultModel, tag: str) -> prng.Key:
    """The key of one fault site: the seed's key with the crc32 of each
    ``/``-separated part of ``tag`` folded in (stable across processes)."""
    key = prng.PRNGKey(fault.seed)
    for part in tag.split("/"):
        key = prng.fold_in(key, zlib.crc32(part.encode()) & 0x7FFFFFFF)
    return key


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _device(device) -> str:
    """A cache key for ``device`` ("cuda" names the current card's index)."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _exp(x: torch.Tensor) -> torch.Tensor:
    # the same bits on every device (a library exp differs by an ulp between
    # the CPU and the card)
    return prng.exp64(x).float()


# ---------------------------------------------------------------------------
# cell-level injection


def stuck_masks(key: prng.Key, shape: Tuple[int, ...], fault: FaultModel,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stuck_on, stuck_off) boolean masks: disjoint, cut from one uniform
    field so the partition is exact at any rate combination."""
    u = prng.uniform(key, shape, device)
    on = u < _f32(fault.stuck_on_rate, device)
    off = ~on & (u < _f32(fault.stuck_on_rate + fault.stuck_off_rate, device))
    return on, off


@functools.lru_cache(maxsize=_CACHE)
def _cell_realization(fault: FaultModel, tag: str, shape: Tuple[int, ...], device: str):
    """(conductance factor or None, stuck_on or None, stuck_off or None)."""
    k_noise, k_stuck = prng.split(fault_key(fault, tag))
    factor = on = off = None
    if fault.g_sigma > 0.0 or fault.read_disturb > 0.0:
        # variation and disturb fold into one exponent: G * exp(sigma*eps - r)
        exponent = -_f32(fault.read_disturb, device)
        if fault.g_sigma > 0.0:
            noise = prng.normal(k_noise, shape, device)
            exponent = _f32(fault.g_sigma, device) * noise + exponent
        factor = _exp(exponent)
    if fault.stuck_rate > 0.0:
        on, off = stuck_masks(k_stuck, shape, fault, device)
    return factor, on, off


def apply_cell_faults(values: torch.Tensor, fault: Optional[FaultModel], tag: str, *,
                      g_on: float, g_off: float = 0.0) -> torch.Tensor:
    """Perturb stored conductances: variation + read disturb + stuck-at.

    ``values`` are the programmed array contents; ``g_on`` / ``g_off`` what a
    stuck cell reads as in that array's value domain.  Stuck-at wins over
    analog noise.  Returns float32 (a new tensor)."""
    if is_null(fault):
        return values
    factor, on, off = _cell_realization(fault, tag, tuple(values.shape), _device(values.device))
    out = values.float()
    if factor is not None:
        out = out * factor
    if on is not None:
        out = torch.where(on, _f32(g_on, values.device), out)
        out = torch.where(off, _f32(g_off, values.device), out)
    return out


# ---------------------------------------------------------------------------
# softmax-engine sites (CAM / LUT / VMM / ADC)


@functools.lru_cache(maxsize=_CACHE)
def _faulty_exp_lut(fmt: FixedPointFormat, fault: FaultModel, tag: str, device: str):
    from repro_torch.core import lut as lut_lib  # core imports this module

    return apply_cell_faults(lut_lib.exp_lut(fmt, device=device), fault, tag,
                             g_on=1.0, g_off=0.0)


def faulty_exp_lut(fmt: FixedPointFormat, fault: FaultModel, tag: str = "softmax/lut",
                   device=None) -> torch.Tensor:
    """The exp LUT crossbar under faults, float32 ``[num_levels]``: G_on
    reads as the top entry ``exp(0) = 1``, G_off as zero."""
    return _faulty_exp_lut(fmt, fault, tag, _device(device))


@functools.lru_cache(maxsize=_CACHE)
def _cam_remap(fmt: FixedPointFormat, fault: FaultModel, tag: str, device: str):
    levels = fmt.num_levels
    on, off = stuck_masks(fault_key(fault, tag), (levels,), fault, device)
    broken = on | off
    idx = torch.arange(levels, device=device)
    # nearest working row at >= k: a suffix min over candidate indices
    cand = torch.where(broken, torch.full_like(idx, levels), idx)
    deeper = torch.flip(torch.cummin(torch.flip(cand, [0]), 0).values, [0])
    # rows with no working deeper row fall back to the nearest shallower one
    shallower = torch.cummax(torch.where(broken, torch.full_like(idx, -1), idx), 0).values
    remap = torch.where(deeper < levels, deeper, torch.clamp(shallower, min=0))
    return remap.to(torch.int32)


def cam_remap(fmt: FixedPointFormat, fault: Optional[FaultModel], tag: str = "softmax/cam",
              device=None) -> Optional[torch.Tensor]:
    """Match-index remap ``[num_levels]`` int32 for CAM stuck faults: a
    broken row's inputs match the nearest working row, deeper first, then
    shallower.  ``None`` when the CAM is fault-free (identity elided)."""
    if is_null(fault) or fault.stuck_rate == 0.0:
        return None
    return _cam_remap(fmt, fault, tag, _device(device))


@functools.lru_cache(maxsize=_CACHE)
def _adc_gain(fault: FaultModel, tag: str) -> float:
    eps = prng.normal(fault_key(fault, tag), ())
    return float(_f32(1.0, None) + _f32(fault.adc_offset_sigma, None) * eps)


def adc_gain(fault: Optional[FaultModel], tag: str = "softmax/adc") -> Optional[float]:
    """Denominator gain of the softmax engine's shared ADC (one float32
    value per realization); ``None`` when ideal."""
    if is_null(fault) or fault.adc_offset_sigma == 0.0:
        return None
    return _adc_gain(fault, tag)


@functools.lru_cache(maxsize=_CACHE)
def _adc_tile_offsets(fault: FaultModel, shape: Tuple[int, ...], tag: str, device: str):
    return _f32(fault.adc_offset_sigma, device) * prng.normal(fault_key(fault, tag), shape, device)


def adc_tile_offsets(fault: Optional[FaultModel], shape: Tuple[int, ...],
                     tag: str = "matmul/adc", device=None) -> Optional[torch.Tensor]:
    """Per-crossbar-tile ADC input offsets in LSB units, float32 ``[Kt, Nt]``,
    added to ``partial / step`` before the ADC's round and clip."""
    if is_null(fault) or fault.adc_offset_sigma == 0.0:
        return None
    return _adc_tile_offsets(fault, tuple(shape), tag, _device(device))
