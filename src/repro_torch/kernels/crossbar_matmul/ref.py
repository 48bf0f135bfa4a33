"""Plain PyTorch model of the crossbar MatMul engine (port of
``repro.kernels.crossbar_matmul.ref``).

The RRAM MatMul engine the paper builds on (ReTransformer style):

* weights quantized to 8-bit ints on 128x128 crossbar tiles, activations to
  8-bit ints (per-tensor symmetric scales);
* each tile's analog partial sum passes a 5-bit ADC: a uniform signed
  quantizer whose step comes from calibration (``adc_step``);
* the quantized partials accumulate digitally across K tiles, in order.

``fault`` adds seeded cell faults to the stored weights (float32 from then
on) and a per-tile ADC input offset.  Rounding is half to even throughout
(``torch.round``, as ``jnp.round``).  The calibration and partial-sum
products run in float64, so no TF32 setting can change them: clean partial
sums are exact integers either way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.hwmodel import faults as faults_lib
from repro_torch.hwmodel.faults import FaultModel


@dataclasses.dataclass(frozen=True)
class CrossbarSpec:
    tile_rows: int = 128  # crossbar rows (K per tile)
    tile_cols: int = 128  # crossbar cols (N per tile)
    adc_bits: int = 5
    weight_bits: int = 8
    input_bits: int = 8

    @property
    def adc_levels(self) -> int:
        # signed symmetric: [-(2^(b-1)-1), +(2^(b-1)-1)]
        return (1 << (self.adc_bits - 1)) - 1


DEFAULT_SPEC = CrossbarSpec()


def _sym_quant(x: torch.Tensor, bits: int):
    """Symmetric per-tensor quantization: int32 codes and the float32 scale."""
    top = (1 << (bits - 1)) - 1
    s = torch.clamp(x.abs().max(), min=1e-12) / top
    q = torch.clamp(torch.round(x / s), -top, top).to(torch.int32)
    return q, s


def quantize_operands(x: torch.Tensor, w: torch.Tensor, spec: CrossbarSpec = DEFAULT_SPEC):
    """``(xq, sx), (wq, sw)`` with per-tensor symmetric scales."""
    xq, sx = _sym_quant(x.float(), spec.input_bits)
    wq, sw = _sym_quant(w.float(), spec.weight_bits)
    return (xq, sx), (wq, sw)


def _pad_to(a: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-a.shape[axis]) % mult
    if not pad:
        return a
    widths = [0, 0] * a.ndim
    widths[2 * (a.ndim - 1 - axis) + 1] = pad  # F.pad lists the last axis first
    return torch.nn.functional.pad(a, widths)


def adc_step(xq: torch.Tensor, wq: torch.Tensor, spec: CrossbarSpec = DEFAULT_SPEC,
             ranging: str = "calibrated") -> torch.Tensor:
    """Per-(k-tile, n-tile) ADC step, float32 ``[Kt, Nt]``.

    ``"calibrated"``: range = the observed max |partial sum| of each tile
    (what a deployed design programs after calibration).  ``"fullscale"``:
    the worst-case column sum (pessimistic).  Operands must already be
    padded to tile multiples."""
    m = xq.shape[0]
    kt = xq.shape[1] // spec.tile_rows
    nt = wq.shape[1] // spec.tile_cols
    wtiles = wq.double().reshape(kt, spec.tile_rows, nt, spec.tile_cols)
    if ranging == "fullscale":
        in_top = (1 << (spec.input_bits - 1)) - 1
        fullscale = wtiles.abs().sum(dim=1).amax(dim=-1) * in_top
    elif ranging == "calibrated":
        xtiles = xq.double().reshape(m, kt, spec.tile_rows)
        fullscale = torch.stack([
            (xtiles[:, k] @ wtiles[k].reshape(spec.tile_rows, -1))
            .abs().reshape(m, nt, spec.tile_cols).amax(dim=(0, 2))
            for k in range(kt)
        ])
    else:
        raise ValueError(f"unknown ranging {ranging!r}")
    return torch.clamp(fullscale.float(), min=1.0) / spec.adc_levels


def apply_weight_faults(wq: torch.Tensor, spec: CrossbarSpec,
                        fault: Optional[FaultModel]) -> torch.Tensor:
    """Perturb the stored (padded, quantized) weights with cell faults:
    variation and read disturb scale them, stuck-at-G_on reads as the top
    code and stuck-at-G_off as zero.  Returns float32 under a fault (the
    conductances leave the integer grid), ``wq`` itself otherwise."""
    if faults_lib.is_null(fault):
        return wq
    w_top = float((1 << (spec.weight_bits - 1)) - 1)
    return faults_lib.apply_cell_faults(wq.float(), fault, "matmul/w", g_on=w_top, g_off=0.0)


def crossbar_accumulate_ref(xq: torch.Tensor, wq: torch.Tensor, step: torch.Tensor,
                            offsets: Optional[torch.Tensor] = None,
                            spec: CrossbarSpec = DEFAULT_SPEC) -> torch.Tensor:
    """The tiled ADC accumulation on padded operands (the plain version of
    the crossbar kernel): per K tile, ``clip(round(partial / step + off),
    ±adc_levels) * step``, summed over K tiles in order.  float32 ``[M, N]``."""
    m = xq.shape[0]
    kt = xq.shape[1] // spec.tile_rows
    nt = wq.shape[1] // spec.tile_cols
    xtiles = xq.double().reshape(m, kt, spec.tile_rows)
    wtiles = wq.double().reshape(kt, spec.tile_rows, nt * spec.tile_cols)
    acc = torch.zeros((m, nt, spec.tile_cols), dtype=torch.float32, device=xq.device)
    for k in range(kt):
        # exact for integer operands; the correctly rounded sum for faulty ones
        partial = (xtiles[:, k] @ wtiles[k]).float().reshape(m, nt, spec.tile_cols)
        st = step[k][None, :, None]
        code = partial / st
        if offsets is not None:
            code = code + offsets[k][None, :, None]  # input-referred offset
        acc = acc + torch.clamp(torch.round(code), -spec.adc_levels, spec.adc_levels) * st
    return acc.reshape(m, nt * spec.tile_cols)


def prepare_operands(x: torch.Tensor, w: torch.Tensor, spec: CrossbarSpec = DEFAULT_SPEC,
                     ranging: str = "calibrated", fault: Optional[FaultModel] = None):
    """What the tiled accumulation takes, built as the reference builds it
    outside its kernel: operands quantized and padded to tile multiples,
    weight-cell faults applied, ADC steps calibrated on the faulty array,
    per-tile ADC offsets.  Returns ``(xq, wq, step, offsets, sx * sw)``."""
    (xq, sx), (wq, sw) = quantize_operands(x, w, spec)
    xq = _pad_to(xq, 1, spec.tile_rows)
    wq = _pad_to(_pad_to(wq, 0, spec.tile_rows), 1, spec.tile_cols)
    wq = apply_weight_faults(wq, spec, fault)
    step = adc_step(xq, wq, spec, ranging)
    offsets = faults_lib.adc_tile_offsets(fault, tuple(step.shape), device=x.device)
    return xq, wq, step, offsets, sx * sw


def crossbar_matmul_ref(x: torch.Tensor, w: torch.Tensor, spec: CrossbarSpec = DEFAULT_SPEC,
                        ranging: str = "calibrated",
                        fault: Optional[FaultModel] = None) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` through the crossbar model (float32 out).
    Calibrated ranging observes the faulty array, as a deployed design
    calibrates after the faults exist."""
    xq, wq, step, offsets, scale = prepare_operands(x, w, spec, ranging, fault)
    return crossbar_accumulate_ref(xq, wq, step, offsets, spec)[:, :w.shape[1]] * scale


def exact_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact product, float32 (summed in float64: no TF32 setting moves it)."""
    return (x.double() @ w.double()).float()
