"""Area / power / latency models for the RRAM crossbar primitives (a copy
of ``repro.hwmodel.crossbar``: analytical model numbers, not measurements)."""

from __future__ import annotations

import dataclasses

from repro_torch.hwmodel import constants as C


@dataclasses.dataclass(frozen=True)
class XbarCost:
    area_mm2: float
    power_w: float  # at full duty
    op_time_s: float  # one operation (VMM read or CAM search)

    def scaled(self, duty: float) -> "XbarCost":
        return XbarCost(self.area_mm2, self.power_w * duty, self.op_time_s)


def vmm_crossbar(rows: int, cols: int, n_adc: int) -> XbarCost:
    """Analog VMM crossbar + shared ADCs + drivers."""
    area = (
        rows * cols * C.RRAM_CELL_AREA
        + rows * C.DRIVER_AREA_PER_ROW
        + cols * C.SA_AREA_PER_COL
        + n_adc * C.ADC5_AREA
    )
    # energy per read: active cells + ADC conversions
    e_read = rows * cols * C.XBAR_READ_ENERGY_PER_CELL
    power = e_read / C.XBAR_READ_TIME + n_adc * C.ADC5_POWER + C.PERIPH_POWER_PER_XBAR
    return XbarCost(area, power, C.XBAR_READ_TIME)


def cam_crossbar(rows: int, cols: int) -> XbarCost:
    """Content-addressable crossbar: parallel match-line search."""
    area = (
        rows * cols * C.RRAM_CELL_AREA
        + rows * C.DRIVER_AREA_PER_ROW
        + cols * C.SA_AREA_PER_COL
    )
    e_search = rows * C.CAM_SEARCH_ENERGY_PER_ROW
    power = e_search / C.CAM_SEARCH_TIME + C.PERIPH_POWER_PER_XBAR
    return XbarCost(area, power, C.CAM_SEARCH_TIME)


def lut_crossbar(rows: int, cols: int) -> XbarCost:
    """LUT read = one-hot driven row read (cheaper than full VMM: one row).

    Power audit (golden-locked in tests/test_hwmodel_golden.py): the LUT
    access is a row *read* — cell settle + SA sense, the same physics the
    per-cell read-energy constant was measured at — not a match-line
    search, so the read-power denominator is ``XBAR_READ_TIME``.  The
    engine still *issues* one LUT access per CAM search (banked rows keep
    the pipeline cadence), which is why ``op_time_s`` stays at the search
    cadence while full-duty power is per-read energy over the read time.
    """
    area = rows * cols * C.RRAM_CELL_AREA + rows * C.DRIVER_AREA_PER_ROW + cols * C.SA_AREA_PER_COL
    e_read = cols * C.XBAR_READ_ENERGY_PER_CELL  # single active row
    power = e_read / C.XBAR_READ_TIME + C.PERIPH_POWER_PER_XBAR
    return XbarCost(area, power, C.CAM_SEARCH_TIME)
