"""The port's training numerics against the JAX reference on the same
inputs: the straight-through STAR softmax and codebook round-trip, the
integer LUT, the precision policies, the ``star_ste`` spec kind and its
routes, the gradients of ``ops.attention`` on both routes, and the kernel
wrappers' refusal to be differentiated.

Tolerances: forwards are bit-equal (``assert_array_equal``); gradients
hold to float32 rounding, ``|port - ref| <= 1e-6 + 1e-5 |ref|`` (the same
products summed in another order), and a gradient the reference gives as
exact zeros must be exact zeros here.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core import fixedpoint as jfp
from repro.core import lut as jlut
from repro.core import precision as jprec
from repro.hwmodel.faults import FaultModel as JFault
from repro.ops import specs as jspecs
from repro_torch import ops
from repro_torch.core import fixedpoint as tfp
from repro_torch.core import lut as tlut
from repro_torch.core import precision as tprec
from repro_torch.hwmodel.faults import FaultModel
from repro_torch.kernels._cuda import KernelGradError
from repro_torch.kernels.crossbar_matmul.kernel import crossbar_matmul
from repro_torch.kernels.crossbar_matmul.ref import DEFAULT_SPEC
from repro_torch.kernels.flash_star import flash_star_attention
from repro_torch.kernels.paged_attention import paged_flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.star_softmax import star_softmax_kernel

# ``repro.core`` exports a function under the module's name
jss = importlib.import_module("repro.core.star_softmax")
tss = importlib.import_module("repro_torch.core.star_softmax")
RTOL, ATOL = 1e-5, 1e-6
FORMATS = ((6, 2), (6, 3), (5, 2))  # CNEWS, MRPC, CoLA
MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
            adc_offset_sigma=0.1, read_disturb=0.01, seed=7)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _rows_with_neg_inf(seed, shape=(6, 40)):
    x = np.random.default_rng(seed).normal(0, 3, shape).astype(np.float32)
    x[0, :5] = -np.inf
    x[3, 7:] = -np.inf
    return x


# ---------------------------------------------------------------------------
# fixed point, LUT, precision


@pytest.mark.parametrize("bits", FORMATS)
def test_quantize_index_dequantize_bit_equal(bits):
    jf, tf = jfp.FixedPointFormat(*bits), tfp.FixedPointFormat(*bits)
    z = np.random.default_rng(1).normal(-8, 20, 4096).astype(np.float32)
    z[:4] = (np.nan, 3.0, 0.0, -1e9)
    want = np.asarray(jfp.quantize_index(jnp.asarray(z), jf))
    got = tfp.quantize_index(torch.from_numpy(z), tf)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert (got.dtype == torch.uint8) == (want.dtype == np.uint8)
    np.testing.assert_array_equal(tfp.dequantize(got, tf).numpy(),
                                  np.asarray(jfp.dequantize(jnp.asarray(want), jf)))
    np.testing.assert_array_equal(tfp.quantize_value(torch.from_numpy(z), tf).numpy(),
                                  np.asarray(jfp.quantize_value(jnp.asarray(z), jf)))


@pytest.mark.parametrize("bits", FORMATS)
def test_quantize_value_ste_forward_and_gradient_match_reference(bits):
    jf, tf = jfp.FixedPointFormat(*bits), tfp.FixedPointFormat(*bits)
    rng = np.random.default_rng(2)
    # inside the clip range, above it (> 0), below min_value, and both edges
    z = np.concatenate([rng.uniform(jf.min_value, 0, 200), rng.uniform(0.01, 5, 20),
                        rng.uniform(jf.min_value - 50, jf.min_value - 0.01, 20),
                        [0.0, jf.min_value]]).astype(np.float32)
    g = rng.normal(size=z.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jfp.quantize_value_ste(v, jf), jnp.asarray(z))
    (gwant,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = tfp.quantize_value_ste(zt, tf)
    (ggot,) = torch.autograd.grad(got, zt, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(ggot.numpy(), np.asarray(gwant))
    assert (ggot[200:240] == 0).all() and (ggot[:200] == torch.from_numpy(g[:200])).all()


@pytest.mark.parametrize("bits", FORMATS)
@pytest.mark.parametrize("out_bits", (2, 5, 8))
def test_exp_lut_int_and_scale_bit_equal(bits, out_bits):
    got = tlut.exp_lut_int(tfp.FixedPointFormat(*bits), out_bits)
    want = np.asarray(jlut.exp_lut_int(jfp.FixedPointFormat(*bits), out_bits))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert tlut.int_lut_scale(out_bits) == jlut.int_lut_scale(out_bits)


def test_exp_lut_int_refuses_out_bits_as_reference():
    for bad in (1, 9):
        with pytest.raises(ValueError, match="out_bits"):
            jlut.exp_lut_int(jfp.DEFAULT_FORMAT, bad)
        with pytest.raises(ValueError, match="out_bits"):
            tlut.exp_lut_int(tfp.DEFAULT_FORMAT, bad)


@pytest.mark.parametrize("dataset", ("cnews", "mrpc", "cola", "CoLA", "sst2"))
def test_policy_for_matches_reference(dataset):
    got, want = tprec.policy_for(dataset), jprec.policy_for(dataset)
    assert (got.int_bits, got.frac_bits) == (want.int_bits, want.frac_bits)


@pytest.mark.parametrize("scale,kw", [(3.0, {}), (40.0, {}), (0.2, {}),
                                      (10.0, {"target_max_abs_err": 0.5}),
                                      (10.0, {"max_frac_bits": 1, "coverage": 0.5})])
def test_calibrate_format_matches_reference(scale, kw):
    z = -np.abs(np.random.default_rng(4).normal(0, scale, 5000)).astype(np.float32)
    z[:3] = (-np.inf, np.nan, 0.0)
    got, want = tprec.calibrate_format(z, **kw), jprec.calibrate_format(z, **kw)
    assert (got.int_bits, got.frac_bits) == (want.int_bits, want.frac_bits)
    empty = tprec.calibrate_format(np.array([np.nan]))
    assert (empty.int_bits, empty.frac_bits) == (6, 2)


# ---------------------------------------------------------------------------
# specs


@pytest.mark.parametrize("policy", ("auto:cnews", "auto:mrpc", "auto:cola", "auto:other"))
def test_auto_precision_resolves_as_reference(policy):
    got = ops.SoftmaxSpec(kind="star", precision=policy).fmt
    want = jops.SoftmaxSpec(kind="star", precision=policy).fmt
    assert (got.int_bits, got.frac_bits) == (want.int_bits, want.frac_bits)
    assert ops.SoftmaxSpec(kind="exact", precision=policy).fmt is None
    assert ops.SoftmaxSpec(precision=policy).tolerance() == jops.SoftmaxSpec(
        precision=policy).tolerance()


def test_bad_precision_raises_as_reference():
    for bad, exc in (("mrpc", ValueError), ("cnews:auto", ValueError), (8, TypeError)):
        with pytest.raises(exc) as want:
            jops.SoftmaxSpec(precision=bad)
        with pytest.raises(exc) as got:
            ops.SoftmaxSpec(precision=bad)
        assert str(got.value) == str(want.value)
    assert ops.specs.SOFTMAX_KINDS == jspecs.SOFTMAX_KINDS


def test_star_ste_refused_by_every_kernel_impl():
    """The kernels have no STE backward: ``pallas`` softmax, attention and
    paged attention and ``pallas_paged`` refuse ``star_ste`` with
    CapabilityError, as the reference's capabilities do."""
    ste = ops.SoftmaxSpec(kind="star_ste")
    x = torch.zeros(2, 8)
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ops.CapabilityError, match="pallas"):
        ops.softmax(x, dataclasses.replace(ste, impl="pallas"))
    with pytest.raises(ops.CapabilityError, match="pallas"):
        ops.attention(q, q, q, ops.AttentionSpec(impl="pallas", softmax=ste))
    kp = torch.zeros(4, 16, 2, 16)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    for impl in ("pallas", "pallas_paged"):
        with pytest.raises(ops.CapabilityError, match=impl):
            ops.paged_attention(q[:, :1], kp, kp, tables,
                                ops.PagedAttentionSpec(impl=impl, softmax=ste),
                                kv_valid_len=torch.tensor([3], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the STE softmax


@pytest.mark.parametrize("mode", ("gather", "onehot", "histogram"))
@pytest.mark.parametrize("faulty", (False, True))
def test_star_softmax_ste_forward_and_vjp_match_reference(mode, faulty):
    bits = (6, 2)
    jf, tf = jfp.FixedPointFormat(*bits), tfp.FixedPointFormat(*bits)
    jfault, tfault = (JFault(**MILD), FaultModel(**MILD)) if faulty else (None, None)
    x = _rows_with_neg_inf(5)
    g = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jss.star_softmax_ste(v, jf, -1, mode, jfault),
                        jnp.asarray(x))
    (gwant,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tss.star_softmax_ste(xt, tf, -1, mode, tfault)
    (ggot,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    plain = tss.star_softmax(torch.from_numpy(x), tf, mode=mode, fault=tfault)
    np.testing.assert_array_equal(got.detach().numpy(), plain.numpy())
    _close(got.detach(), want, "forward")
    _close(ggot, gwant, "vjp")
    assert np.isfinite(ggot.numpy()).all()


def test_star_softmax_ste_vjp_along_axis_0():
    x = _rows_with_neg_inf(7).T.copy()
    g = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jss.star_softmax_ste(v, jfp.FORMAT_MRPC, 0, "gather"),
                     jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tss.star_softmax_ste(xt, tfp.FORMAT_MRPC, 0, "gather")
    (ggot,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    _close(ggot, vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("mode", ("gather", "histogram"))
def test_quantization_error_matches_reference(mode):
    x = np.random.default_rng(9).normal(0, 4, (5, 300)).astype(np.float32)
    got = tss.quantization_error(torch.from_numpy(x), tfp.FORMAT_COLA, mode=mode)
    want = jss.quantization_error(jnp.asarray(x), jfp.FORMAT_COLA, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_reference_softmax_impl_dispatches_star_ste():
    """``ops.softmax`` with ``kind="star_ste"`` on the ``reference`` impl:
    a masked entry enters as NEG_INF (the deepest LUT row), as the
    reference's impl does; forward and gradient equal the reference's."""
    x = np.random.default_rng(10).normal(0, 2, (3, 24)).astype(np.float32)
    where = np.random.default_rng(11).random((3, 24)) > 0.3
    g = np.random.default_rng(12).normal(size=x.shape).astype(np.float32)
    spec_j = jops.SoftmaxSpec(kind="star_ste", mode="histogram", precision="auto:mrpc")
    spec_t = ops.SoftmaxSpec(kind="star_ste", mode="histogram", precision="auto:mrpc")
    want, vjp = jax.vjp(lambda v: jops.softmax(v, spec_j, where=jnp.asarray(where)),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ops.softmax(xt, spec_t, where=torch.from_numpy(where))
    (ggot,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    _close(got.detach(), want)
    _close(ggot, vjp(jnp.asarray(g))[0])


# ---------------------------------------------------------------------------
# property 1: gradients of ops.attention on both routes


@pytest.mark.parametrize("impl", ("reference", "xla"))
@pytest.mark.parametrize("kind", ("star", "star_ste", "exact"))
def test_attention_gradients_match_reference(impl, kind):
    """q, k, v gradients of ``ops.attention`` against ``jax.vjp`` of the
    reference's.  ``xla`` at Tk 40 > block_kv 16 runs the online-blocked
    loop, which takes the integer-grid form for both STAR kinds: there the
    reference gives Q and K exact zeros even under ``star_ste``, and so
    must the port; the whole-operand ``reference`` route gives them the STE
    gradient under ``star_ste``."""
    rng = np.random.default_rng(13)
    q = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    g = rng.normal(size=q.shape).astype(np.float32)
    kw = dict(impl=impl, causal=True, block_kv=16)
    spec_j = jops.AttentionSpec(softmax=jops.SoftmaxSpec(kind=kind), **kw)
    spec_t = ops.AttentionSpec(softmax=ops.SoftmaxSpec(kind=kind), **kw)
    want, vjp = jax.vjp(lambda a, b, c: jops.attention(a, b, c, spec_j),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gwant = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = ops.attention(*args, spec_t)
    ggot = torch.autograd.grad(got, args, torch.from_numpy(g), allow_unused=True)
    _close(got.detach(), want, "output")
    for name, gg, gw in zip("qkv", ggot, gwant):
        gw = np.asarray(gw)
        if not gw.any():  # exact zeros in the reference: none reaches it here either
            assert gg is None or not gg.any(), name
            continue
        np.testing.assert_allclose(gg.numpy(), gw, rtol=1e-4, atol=2e-5 * np.abs(gw).max(),
                                   err_msg=name)
    zero_qk = not np.asarray(gwant[0]).any() and not np.asarray(gwant[1]).any()
    assert zero_qk == (kind == "star" or (kind == "star_ste" and impl == "xla"))


# ---------------------------------------------------------------------------
# kernel wrappers refuse to be differentiated


def _grad_cases():
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    info = torch.tensor([0, 8], dtype=torch.int32)
    pages = torch.from_numpy(rng.normal(size=(4, 16, 1, 16)).astype(np.float32))
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    valid = torch.tensor([20], dtype=torch.int32)
    xdt = torch.from_numpy(rng.normal(size=(1, 8, 2, 4)).astype(np.float32))
    a = -torch.rand(1, 8, 2)
    bc = torch.from_numpy(rng.normal(size=(1, 8, 4)).astype(np.float32))
    xq = torch.randint(-8, 8, (128, 128), dtype=torch.int32)
    wq = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32))
    step = torch.ones(1, 1)
    return {
        "flash_star_attention": (lambda t: flash_star_attention(t, q, q, info, fmt=tfp.DEFAULT_FORMAT), q),
        "paged_flash_attention": (lambda t: paged_flash_attention(
            t, pages, pages, tables, valid, fmt=tfp.DEFAULT_FORMAT), q[:, :, 0]),
        "star_softmax_kernel": (lambda t: star_softmax_kernel(t, tfp.DEFAULT_FORMAT), q[0, 0]),
        "ssd_scan": (lambda t: ssd_scan(t, a, bc, bc, chunk=4), xdt),
        "crossbar_matmul": (lambda t: crossbar_matmul(xq, t, step, spec=DEFAULT_SPEC), wq),
    }


@pytest.mark.parametrize("name", sorted(_grad_cases()))
def test_kernel_wrapper_refuses_to_be_differentiated(name):
    """On the CPU as on the card: an input that requires grad under grad
    mode raises ``KernelGradError`` before the plain version runs; the same
    call under ``torch.no_grad()`` (or on a tensor that needs no gradient)
    runs."""
    fn, x = _grad_cases()[name]
    with pytest.raises(KernelGradError, match=name):
        fn(x.clone().requires_grad_(True))
    with torch.no_grad():
        fn(x.clone().requires_grad_(True))
    fn(x)
