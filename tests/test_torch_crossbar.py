"""The port's crossbar MatMul engine model against the JAX reference.

Inputs from numpy seeds through both packages:

* ``quantize_operands``, ``adc_step`` (both rangings) and the clean
  ``crossbar_matmul_ref`` bit for bit: clean partial sums are exact integers
  in any order, and every later step is the same sequence of float32 ops;
* the JAX Pallas kernel itself differs from the JAX ref by an ulp (its
  interpret-mode jit fuses the ADC multiply and the accumulate), so the
  ``hwmodel`` route is held to it with the reference test's own
  ``atol=1e-4``;
* under faults the stored weights differ from the reference's by a few
  ulps (normal draws, ``tests/test_torch_faults.py``), which moves outputs
  by ulps; an ADC code flipped at a half-step would move one by a whole
  step (a 15th of a tile's full scale), and ``atol=1e-5`` admits none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.hwmodel.faults import FaultModel as JaxFault
from repro.kernels.crossbar_matmul import ref as jref
from repro_torch import ops
from repro_torch.kernels.crossbar_matmul import kernel as xk
from repro_torch.kernels.crossbar_matmul import ref as tref

MKN = [(16, 128, 128), (7, 300, 190), (64, 256, 384), (1, 128, 64)]
MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
            adc_offset_sigma=0.1, read_disturb=0.01, seed=7)
SEVERE = dict(stuck_on_rate=0.6, stuck_off_rate=0.2, seed=3)
VARIATION = dict(g_sigma=0.3, adc_offset_sigma=0.3, seed=2)


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.05).astype(np.float32))


def _padded(x, w):
    xq, wq, _, _, _ = tref.prepare_operands(torch.from_numpy(x), torch.from_numpy(w))
    return xq, wq


@pytest.mark.parametrize("mkn", MKN)
def test_quantize_pad_and_step_bit_exact(mkn):
    x, w = _operands(1, *mkn)
    (xq, sx), (wq, sw) = tref.quantize_operands(torch.from_numpy(x), torch.from_numpy(w))
    (jxq, jsx), (jwq, jsw) = jref.quantize_operands(jnp.asarray(x), jnp.asarray(w))
    assert np.array_equal(xq.numpy(), np.asarray(jxq)) and np.array_equal(wq.numpy(), np.asarray(jwq))
    assert float(sx) == float(jsx) and float(sw) == float(jsw)
    xq, wq = _padded(x, w)
    jx = jref._pad_to(jxq, 1, 128)
    jw = jref._pad_to(jref._pad_to(jwq, 0, 128), 1, 128)
    assert np.array_equal(xq.numpy(), np.asarray(jx)) and np.array_equal(wq.numpy(), np.asarray(jw))
    for ranging in ("calibrated", "fullscale"):
        step = tref.adc_step(xq, wq, ranging=ranging)
        assert step.dtype == torch.float32
        assert np.array_equal(step.numpy(), np.asarray(jref.adc_step(jx, jw, ranging=ranging)))
    with pytest.raises(ValueError, match="ranging"):
        tref.adc_step(xq, wq, ranging="bogus")


@pytest.mark.parametrize("fault", [MILD, SEVERE, VARIATION], ids=["mild", "severe", "variation"])
def test_weight_faults_and_faulty_step_close(fault):
    x, w = _operands(2, 32, 256, 384)
    xq, wq = _padded(x, w)
    got = tref.apply_weight_faults(wq, tref.DEFAULT_SPEC, ops.FaultModel(**fault))
    ref = np.asarray(jref.apply_weight_faults(jnp.asarray(wq.numpy()), jref.DEFAULT_SPEC,
                                              JaxFault(**fault)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert np.array_equal(got.numpy() == 127.0, ref == 127.0)  # stuck-on cells
    step = tref.adc_step(xq, got)
    np.testing.assert_allclose(step.numpy(), np.asarray(jref.adc_step(jnp.asarray(xq.numpy()),
                                                                      jnp.asarray(ref))), rtol=1e-6)
    assert tref.apply_weight_faults(wq, tref.DEFAULT_SPEC, None) is wq


@pytest.mark.parametrize("mkn", MKN)
def test_crossbar_ref_bit_exact_and_hwmodel_route(mkn):
    x, w = _operands(5, *mkn)
    ref = np.asarray(jref.crossbar_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    got = tref.crossbar_matmul_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (mkn[0], mkn[2]) and np.array_equal(got.numpy(), ref)
    pallas = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w),
                                    jops.MatmulSpec(impl="hwmodel", block_m=32)))
    routed = ops.matmul(torch.from_numpy(x), torch.from_numpy(w), ops.MatmulSpec(impl="hwmodel"))
    assert np.array_equal(routed.numpy(), got.numpy())  # the plain version of the kernel
    np.testing.assert_allclose(routed.numpy(), pallas, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fault", [MILD, SEVERE, VARIATION], ids=["mild", "severe", "variation"])
@pytest.mark.parametrize("mkn", MKN)
def test_faulty_crossbar_within_tolerance(mkn, fault):
    x, w = _operands(5, *mkn)
    ref = np.asarray(jref.crossbar_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                              fault=JaxFault(**fault)))
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                     ops.MatmulSpec(impl="hwmodel", fault=ops.FaultModel(**fault)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert np.array_equal(got.numpy(), tref.crossbar_matmul_ref(
        torch.from_numpy(x), torch.from_numpy(w), fault=ops.FaultModel(**fault)).numpy())


def test_matmul_backends_and_accuracy():
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(32, 256)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(256, 256)) * 0.05, dtype=torch.float32)
    assert torch.equal(ops.matmul(x, w), torch.matmul(x, w))
    exact = tref.exact_matmul_ref(x, w)
    cal = ops.matmul(x, w, ops.MatmulSpec(impl="hwmodel"))
    fs = ops.matmul(x, w, ops.MatmulSpec(impl="hwmodel", ranging="fullscale"))
    e_cal, e_fs = float((cal - exact).norm()), float((fs - exact).norm())
    assert e_cal / float(exact.norm()) < 0.12  # 5-bit ADC, calibrated ranging
    assert e_fs > 3 * e_cal
    errs = [float((ops.matmul(x, w, ops.MatmulSpec(
        impl="hwmodel", crossbar=tref.CrossbarSpec(adc_bits=b))) - exact).norm()) for b in (3, 5, 7)]
    assert errs[0] > errs[1] > errs[2]
    with ops.use(matmul="hwmodel"):
        assert torch.equal(ops.matmul(x, w), cal)
    with pytest.raises(ValueError, match="ranging"):
        ops.MatmulSpec(ranging="bogus")


def test_guard_trips_on_a_severe_crossbar_fault():
    x, w = _operands(7, 16, 256, 128)
    tg = ops.AccuracyGuard(ops.GuardConfig())
    jg = jops.AccuracyGuard(jops.GuardConfig())
    spec_t = ops.MatmulSpec(impl="hwmodel", fault=ops.FaultModel(**SEVERE))
    spec_j = jops.MatmulSpec(impl="hwmodel", fault=JaxFault(**SEVERE))
    with pytest.warns(ops.GuardTripWarning):
        out = ops.matmul(torch.from_numpy(x), torch.from_numpy(w), spec_t, guard=tg)
    with pytest.warns(UserWarning):
        jops.matmul(jnp.asarray(x), jnp.asarray(w), spec_j, guard=jg)
    assert torch.equal(out, torch.matmul(torch.from_numpy(x), torch.from_numpy(w)))  # xla fallback
    ts, js = tg.stats(), jg.stats()
    assert ts["trips"] == js["trips"] == 1 and ts["tripped"] and ts["fallbacks"] == 1
    assert ts["last_error"] == pytest.approx(js["last_error"], rel=1e-4)
    # the clean 5-bit engine: relative max-abs error ~0.06 at this shape
    clean = ops.AccuracyGuard(ops.GuardConfig(tolerance=0.2))
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w), ops.MatmulSpec(impl="hwmodel"),
                     guard=clean)
    assert clean.stats()["trips"] == 0 and clean.stats()["checks"] == 1
    assert torch.equal(got, ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                                       ops.MatmulSpec(impl="hwmodel")))


def test_kernel_wrapper_checks_its_operands():
    xq, wq = _padded(*_operands(8, 4, 128, 128))
    step = tref.adc_step(xq, wq)
    with pytest.raises(ValueError, match="padded"):
        xk.crossbar_matmul(xq[:, :100], wq[:100], step)
    with pytest.raises(ValueError, match="step"):
        xk.crossbar_matmul(xq, wq, step[:, :0])
    out = xk.crossbar_matmul(xq, wq, step)  # int32 codes travel as int8 at 8 bits
    assert torch.equal(out, tref.crossbar_accumulate_ref(xq, wq, step))
    wide = tref.CrossbarSpec(weight_bits=12, input_bits=12)
    assert torch.equal(xk.crossbar_matmul(xq, wq, step, spec=wide),
                       tref.crossbar_accumulate_ref(xq, wq, step, spec=wide))
