"""Hardware constants for the analytical RRAM/CMOS cost model.

Provenance tags:
  [paper]   — value stated in the STAR paper itself
  [lit]     — published literature value (ISAAC/PipeLayer/NeuroSim/Softermax)
  [derived] — computed from the above
  [calib]   — calibrated so the model lands inside the published envelope
              (the paper reports only *ratios*; absolute scale needs one
              anchor per table, which is standard for no-RTL reproduction)

All areas mm^2, powers W, times s, energies J.  Node: 32 nm.  A copy of
``repro.hwmodel.constants``; none of these is a measurement of the H100.
"""

# ---- RRAM crossbar primitives (NeuroSim-era, 32nm) --------------------------
RRAM_CELL_AREA = 0.04e-6  # mm^2 per 1T1R cell (~40F^2 incl. wiring) [lit]
XBAR_READ_TIME = 100e-9  # one VMM read incl. ADC [lit: ISAAC/PipeLayer]
XBAR_READ_ENERGY_PER_CELL = 0.08e-12  # J per active cell per read [lit]
CAM_SEARCH_TIME = 2e-9  # parallel match-line search [lit: RRAM TCAM]
CAM_SEARCH_ENERGY_PER_ROW = 0.4e-15  # J per row per search [lit]

# peripheral overheads (per crossbar)
ADC5_AREA = 0.0012  # 5-bit SAR ADC [lit: ISAAC 8b=0.0096mm^2, scaled]
ADC5_POWER = 1.0e-3  # W at read rate [lit]
DRIVER_AREA_PER_ROW = 0.10e-6  # mm^2 (DAC/WL driver) [lit]
SA_AREA_PER_COL = 0.06e-6  # sense amp per column [lit]
PERIPH_POWER_PER_XBAR = 0.15e-3  # controllers, mux [calib]

# ---- STAR softmax engine geometry (paper Section III) -----------------------
CAMSUB_ROWS, CAMSUB_COLS = 512, 18  # [paper]
CAM_ROWS, CAM_COLS = 256, 18  # [paper] (also LUT, VMM crossbars)
N_ADC_SOFTMAX = 2  # shared ADCs across the small softmax crossbars [calib]
DIVIDER_AREA = 0.002  # digital divider, 32nm [lit]
DIVIDER_POWER = 0.8e-3  # [lit]
COUNTER_AREA = 0.0004  # 256-bin counter array [lit]
COUNTER_POWER = 0.2e-3  # [lit]

# ---- baseline digital softmax unit (seq 128, 8-bit) -------------------------
# A straightforward pipelined CMOS softmax (exp LUT per lane + adder tree +
# divider), 16 lanes; absolute scale anchored to Softermax's reported
# baseline envelope. [calib anchored on lit]
CMOS_SOFTMAX_AREA = 0.10  # mm^2 [calib anchor for Table I area scale]
CMOS_SOFTMAX_POWER = 0.165  # W [calib anchor for Table I power scale]
# Softermax relative numbers [paper Table I / Softermax paper]
SOFTERMAX_REL_AREA = 0.33
SOFTERMAX_REL_POWER = 0.12

# ---- MatMul engine (follows ReTransformer) ----------------------------------
MM_XBAR_ROWS = MM_XBAR_COLS = 128  # [paper]
MM_ADC_BITS = 5  # [paper]
MM_N_XBARS = 64  # engine tile count [calib to ReTransformer scale]
MM_ADCS_PER_XBAR = 4  # column-shared [lit: ISAAC-style sharing]
# effective serialization of one logical 128x128 VMM: 32:1 column mux with
# input-bit pipelining overlap ~0.9 -> 28.6 reads per VMM [calib]
MM_SERIALIZATION = 28.6
# thin digital vector unit on PipeLayer/ReTransformer-class designs that
# the softmax falls back to (the paper's premise) [calib]
CMOS_SOFTMAX_OPS_PER_S = 2.42e9

# ---- published baseline system efficiencies (GOPS/s/W) ----------------------
GPU_EFFICIENCY = 20.0  # Titan RTX on BERT attention [paper: 612.66/30.63]
PIPELAYER_EFFICIENCY = 141.8  # [paper: 612.66/4.32; PipeLayer-era]
RETRANSFORMER_EFFICIENCY = 467.7  # [paper: 612.66/1.31]
STAR_EFFICIENCY_PAPER = 612.66  # [paper]

# ---- BERT-base attention workload (paper's evaluation model) ----------------
BERT_D_MODEL = 768
BERT_HEADS = 12
BERT_FF = 3072
