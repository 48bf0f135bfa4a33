"""The port's copy of the paper's analytical cost model (Table I, Fig. 3)
against the JAX package's: the same Python arithmetic in the same order, so
every number is compared with ``==``.  These are model numbers, not
measurements of any device.  The goldens of ``tests/test_hwmodel_golden.py``
are held for the port as well, at that file's own ``rel=1e-9``."""

import dataclasses

import pytest

from repro_torch.hwmodel import constants as TC
from repro_torch.hwmodel import crossbar as tx
from repro_torch.hwmodel import star_engine as te

jc = pytest.importorskip("repro.hwmodel.constants")
from repro.hwmodel import crossbar as jx  # noqa: E402
from repro.hwmodel import star_engine as je  # noqa: E402

from test_hwmodel_golden import FIG3_GOLDEN, REL, TABLE1_GOLDEN  # noqa: E402


def test_constants_equal_the_reference():
    names = [n for n in dir(jc) if n.isupper()]
    assert names and names == [n for n in dir(TC) if n.isupper()]
    for n in names:
        assert getattr(TC, n) == getattr(jc, n), n


def test_table1_equals_the_reference():
    assert te.table1() == je.table1()


@pytest.mark.parametrize("seq", [128, 256, 512])
def test_fig3_equals_the_reference(seq):
    assert te.fig3(seq) == je.fig3(seq)


@pytest.mark.parametrize("seq", [128, 512])
@pytest.mark.parametrize("on_rram", [True, False])
@pytest.mark.parametrize("pipeline", [True, False])
def test_system_efficiency_equals_the_reference(seq, on_rram, pipeline):
    got = te.system_efficiency(seq, softmax_on_rram=on_rram, vector_pipeline=pipeline)
    assert got == je.system_efficiency(seq, softmax_on_rram=on_rram, vector_pipeline=pipeline)


def test_engine_costs_equal_the_reference():
    for got, want in ((te.star_softmax_engine_cost(), je.star_softmax_engine_cost()),
                      (te.matmul_engine_cost(), je.matmul_engine_cost())):
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("rows,cols,n_adc", [(128, 128, 4), (256, 18, 2), (512, 16, 1)])
def test_crossbar_primitives_equal_the_reference(rows, cols, n_adc):
    pairs = ((tx.vmm_crossbar(rows, cols, n_adc), jx.vmm_crossbar(rows, cols, n_adc)),
             (tx.cam_crossbar(rows, cols), jx.cam_crossbar(rows, cols)),
             (tx.lut_crossbar(rows, cols), jx.lut_crossbar(rows, cols)))
    for got, want in pairs:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert dataclasses.astuple(got.scaled(0.25)) == dataclasses.astuple(want.scaled(0.25))


def test_goldens_hold_for_the_port():
    t, f = te.table1(), te.fig3()
    got = {"ours_area": t["ours_model"]["area"], "ours_power": t["ours_model"]["power"],
           "ours_area_mm2": t["ours_abs"]["area_mm2"], "ours_power_w": t["ours_abs"]["power_w"],
           "vs_softermax_area": t["vs_softermax_model"]["area"],
           "vs_softermax_power": t["vs_softermax_model"]["power"]}
    for key, want in TABLE1_GOLDEN.items():
        assert got[key] == pytest.approx(want, rel=REL), key
    for key, want in FIG3_GOLDEN.items():
        assert f[key] == pytest.approx(want, rel=REL), key
