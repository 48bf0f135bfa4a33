"""System-level model: STAR softmax engine + MatMul engine + pipeline.

Reproduces Table I (softmax engine area/power vs CMOS baseline and
Softermax) and Fig 3 (computing efficiency vs GPU / PipeLayer /
ReTransformer) from component constants.  A copy of
``repro.hwmodel.star_engine``, float for float: these are the analytical
model's numbers for the paper's RRAM design, not measurements of any device.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.hwmodel import constants as C
from repro_torch.hwmodel.crossbar import cam_crossbar, lut_crossbar, vmm_crossbar, XbarCost


# ---------------------------------------------------------------------------
# Table I: the softmax engine alone


def star_softmax_engine_cost() -> XbarCost:
    """CAM/SUB + CAM + LUT + VMM crossbars + counter + divider (paper §III)."""
    camsub = cam_crossbar(C.CAMSUB_ROWS, C.CAMSUB_COLS)
    cam = cam_crossbar(C.CAM_ROWS, C.CAM_COLS)
    lut = lut_crossbar(C.CAM_ROWS, C.CAM_COLS)
    vmm = vmm_crossbar(C.CAM_ROWS, C.CAM_COLS, n_adc=C.N_ADC_SOFTMAX)
    area = (
        camsub.area_mm2 + cam.area_mm2 + lut.area_mm2 + vmm.area_mm2
        + C.DIVIDER_AREA + C.COUNTER_AREA
    )
    power = (
        camsub.power_w + cam.power_w + lut.power_w + vmm.power_w
        + C.DIVIDER_POWER + C.COUNTER_POWER
    )
    # one softmax vector (length d): d CAM searches pipelined with LUT reads,
    # one VMM read for the sum, one divide pass
    return XbarCost(area, power, C.CAM_SEARCH_TIME)


def table1() -> Dict[str, Dict[str, float]]:
    ours = star_softmax_engine_cost()
    rel_area = ours.area_mm2 / C.CMOS_SOFTMAX_AREA
    rel_power = ours.power_w / C.CMOS_SOFTMAX_POWER
    return {
        "baseline_cmos": {"area": 1.0, "power": 1.0},
        "softermax": {"area": C.SOFTERMAX_REL_AREA, "power": C.SOFTERMAX_REL_POWER},
        "ours_model": {"area": rel_area, "power": rel_power},
        "ours_paper": {"area": 0.06, "power": 0.05},
        "ours_abs": {"area_mm2": ours.area_mm2, "power_w": ours.power_w},
        "vs_softermax_model": {
            "area": rel_area / C.SOFTERMAX_REL_AREA,
            "power": rel_power / C.SOFTERMAX_REL_POWER,
        },
        "vs_softermax_paper": {"area": 0.20, "power": 0.44},
    }


# ---------------------------------------------------------------------------
# Fig 3: system computing efficiency (GOPS/s/W) on BERT-base attention


def _attention_workload(seq: int) -> Dict[str, float]:
    d, h = C.BERT_D_MODEL, C.BERT_HEADS
    mm_ops = 2 * seq * d * d * 4 + 2 * 2 * seq * seq * d  # QKVO + QK^T + PV
    mm_ops += 2 * 2 * seq * d * C.BERT_FF  # FFN
    softmax_elems = h * seq * seq
    softmax_ops = 5 * softmax_elems  # exp + max + sub + sum + div per element
    return {"mm_ops": mm_ops, "softmax_ops": softmax_ops, "softmax_elems": softmax_elems}


def matmul_engine_cost() -> XbarCost:
    x = vmm_crossbar(C.MM_XBAR_ROWS, C.MM_XBAR_COLS, n_adc=C.MM_ADCS_PER_XBAR)
    return XbarCost(
        x.area_mm2 * C.MM_N_XBARS, x.power_w * C.MM_N_XBARS, x.op_time_s
    )


def system_efficiency(seq: int = 128, softmax_on_rram: bool = True,
                      vector_pipeline: bool = True) -> Dict[str, float]:
    """GOPS/s/W for the RRAM attention accelerator.

    softmax_on_rram=False, vector_pipeline=False  -> ReTransformer-like
    softmax_on_rram=True,  vector_pipeline=True   -> STAR
    """
    w = _attention_workload(seq)
    mm = matmul_engine_cost()
    sm = star_softmax_engine_cost()

    # MatMul engine throughput: ops per crossbar read x crossbars
    mm_ops_per_read = 2 * C.MM_XBAR_ROWS * C.MM_XBAR_COLS
    mm_time = (w["mm_ops"] / (mm_ops_per_read * C.MM_N_XBARS)
               * C.XBAR_READ_TIME * C.MM_SERIALIZATION)

    if softmax_on_rram:
        # one CAM search + LUT read per element, fully pipelined
        sm_time = w["softmax_elems"] * C.CAM_SEARCH_TIME
        sm_power = sm.power_w
    else:
        # digital softmax on the thin shared vector unit (the paper's
        # premise: softmax runs at operand granularity on general circuits)
        sm_time = w["softmax_ops"] / C.CMOS_SOFTMAX_OPS_PER_S
        sm_power = C.CMOS_SOFTMAX_POWER

    if vector_pipeline:
        # vector-grained pipeline: softmax overlaps matmul; the engine-level
        # critical path is max(mm, softmax) plus a fill bubble
        total_time = max(mm_time, sm_time) * 1.08
    else:
        # operand-grained: stages serialize
        total_time = mm_time + sm_time

    total_ops = w["mm_ops"] + w["softmax_ops"]
    total_power = mm.power_w + sm_power
    gops_per_w = total_ops / total_time / total_power / 1e9
    return {
        "gops_per_w": gops_per_w,
        "mm_time": mm_time,
        "softmax_time": sm_time,
        "softmax_share": sm_time / (mm_time + sm_time),
        "power_w": total_power,
    }


def fig3(seq: int = 128) -> Dict[str, float]:
    star = system_efficiency(seq, softmax_on_rram=True, vector_pipeline=True)
    retr = system_efficiency(seq, softmax_on_rram=False, vector_pipeline=False)
    return {
        "star_model": star["gops_per_w"],
        "retransformer_model": retr["gops_per_w"],
        "star_paper": C.STAR_EFFICIENCY_PAPER,
        "retransformer_paper": C.RETRANSFORMER_EFFICIENCY,
        "pipelayer_paper": C.PIPELAYER_EFFICIENCY,
        "gpu_paper": C.GPU_EFFICIENCY,
        "star_vs_gpu_model": star["gops_per_w"] / C.GPU_EFFICIENCY,
        "star_vs_retransformer_model": star["gops_per_w"] / retr["gops_per_w"],
        "star_vs_gpu_paper": 30.63,
        "star_vs_retransformer_paper": 1.31,
    }
