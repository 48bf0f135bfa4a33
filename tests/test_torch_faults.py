"""The port's fault layer and accuracy guard against the JAX reference.

Inputs come from numpy seeds and go through both packages.  What is held,
and how tightly:

* ``hwmodel.prng`` against ``jax.random``: keys, ``fold_in`` of the crc32
  site tags, ``split``, raw bits and ``uniform`` bit for bit; ``normal``
  within 4 float32 ulps (its ``log1p`` is correctly rounded, XLA's is not);
* stuck masks and CAM remaps bit for bit (one flipped cell is a different
  device); the faulty LUTs, the ADC gain and the tile offsets, which come
  from normal draws, within 4 ulps;
* STAR softmax under faults, every mode, with and without ``where``, and the
  softmax ``pallas`` route against the JAX Pallas kernels (interpret mode)
  within ``rtol=1e-6``: the numerators differ by those ulps and the
  denominators by summation order;
* guard counters equal to the JAX guard's on identical inputs; greedy tokens
  under faulty attention equal to the JAX engine's.
"""

import dataclasses
import importlib
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import lut as jax_lut
from repro.core.attention import SoftmaxConfig as JaxSoftmaxConfig
from repro.core.attention import attention as jax_attention
from repro.core.fixedpoint import FixedPointFormat as JFmt
from repro.hwmodel import faults as jf
from repro.kernels.star_softmax.kernel import star_softmax_pallas
from repro.models.param import materialize as jax_materialize
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import ContinuousConfig as JaxConfig
from repro_torch import ops
from repro_torch.configs import get_smoke_config
from repro_torch.core import lut as lut_lib
from repro_torch.core.attention import SoftmaxConfig, attention, blocked_attention
from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.hwmodel import faults as tf
from repro_torch.hwmodel import prng
from repro_torch.models.param import from_reference
from repro_torch.models.registry import build_model
from repro_torch.ops.registry import CapabilityError, OpDispatchError
from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

jax_core_softmax = importlib.import_module("repro.core.star_softmax")
port_core_softmax = importlib.import_module("repro_torch.core.star_softmax")

MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
            adc_offset_sigma=0.1, read_disturb=0.01, seed=7)
SEVERE = dict(stuck_on_rate=0.6, stuck_off_rate=0.2, seed=3)
FAULTS = {"mild": MILD, "severe": SEVERE, "variation": dict(g_sigma=0.3, seed=11),
          "disturb": dict(read_disturb=0.2, seed=1)}
FORMATS = [(6, 2), (6, 3), (5, 2)]
MODES = ("gather", "onehot", "histogram")
ULPS = 4
RTOL = 1e-6


def _ulps(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def _key(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _x(seed, shape, scale=4.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# prng


@pytest.mark.parametrize("seed", [0, 3, 7, 2**31 - 1, -1])
def test_prng_keys_fold_in_and_split_bit_exact(seed):
    k = jax.random.PRNGKey(seed)
    assert prng.PRNGKey(seed) == _key(k)
    for part in ("softmax", "lut", "vmm", "cam", "adc", "matmul", "w"):
        data = zlib.crc32(part.encode()) & 0x7FFFFFFF
        assert prng.fold_in(prng.PRNGKey(seed), data) == _key(jax.random.fold_in(k, data))
    for num in (2, 3):
        assert list(prng.split(prng.PRNGKey(seed), num)) == [_key(s) for s in jax.random.split(k, num)]
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2**31)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (256,), (64, 300)])
def test_prng_bits_and_uniform_bit_exact(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(5), 11)
    pk = prng.fold_in(prng.PRNGKey(5), 11)
    bits = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.random_bits(pk, shape).numpy(), bits)
    u = np.asarray(jax.random.uniform(k, shape))
    assert _ulps(prng.uniform(pk, shape).numpy(), u) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prng_normal_within_ulps(seed):
    k = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.normal(k, (50000,)))
    got = prng.normal(prng.PRNGKey(seed), (50000,)).numpy()
    assert _ulps(got, ref) <= ULPS
    x = np.array([1.0, -1.0, 0.0], np.float32)
    assert np.array_equal(prng.erfinv(torch.from_numpy(x)).numpy(),
                          np.asarray(jax.lax.erf_inv(jnp.asarray(x))))


def test_device_independent_exp_and_log1p_are_accurate():
    """``exp64`` / ``log1p64`` (basic IEEE ops only, so every device gives
    the same bits) agree with the math library to 3 float64 ulps, and their
    float32 roundings equal the library's on these inputs."""
    x = torch.cat([torch.linspace(-30, 30, 200001, dtype=torch.float64),
                   torch.tensor([0.0, -700.0, 1e-300], dtype=torch.float64)])
    ref = torch.exp(x)
    assert float(((prng.exp64(x) - ref) / ref).abs().max()) <= 3 * 2.3e-16
    assert torch.equal(prng.exp64(x).float(), ref.float())
    y = -torch.rand(300000, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    y = torch.cat([y, torch.tensor([0.0, -1e-300, -1e-12, 1e-20, 3.5, -0.9999999403953552],
                                   dtype=torch.float64)])
    ref = torch.log1p(y)
    err = (prng.log1p64(y) - ref).abs() / torch.where(ref == 0, 1.0, ref.abs())
    assert float(err.max()) <= 3 * 2.3e-16
    assert torch.equal(prng.log1p64(y).float(), ref.float())


# ---------------------------------------------------------------------------
# FaultModel and the spec contract


def test_fault_model_validation():
    with pytest.raises(ValueError):
        tf.FaultModel(g_sigma=-0.1)
    with pytest.raises(ValueError):
        tf.FaultModel(stuck_on_rate=1.5)
    with pytest.raises(ValueError):
        tf.FaultModel(stuck_on_rate=0.7, stuck_off_rate=0.7)
    assert tf.FaultModel().is_null and tf.is_null(None)
    assert not tf.FaultModel(**MILD).is_null
    assert tf.FaultModel.after_reads(100, 1e-4).read_disturb == pytest.approx(0.01)
    for kw in FAULTS.values():
        j, t = jf.FaultModel(**kw), tf.FaultModel(**kw)
        assert (j.is_null, j.stuck_rate) == (t.is_null, t.stuck_rate)


def test_null_fault_normalizes_to_none_in_specs():
    spec = ops.SoftmaxSpec(fault=tf.FaultModel(seed=42))
    assert spec.fault is None and spec == ops.SoftmaxSpec()
    assert ops.MatmulSpec(fault=tf.FaultModel()).fault is None
    aspec = ops.AttentionSpec(fault=tf.FaultModel())
    assert aspec.fault is None and aspec.softmax.fault is None
    mild = tf.FaultModel(**MILD)
    assert ops.AttentionSpec(fault=mild).softmax.fault == mild
    with pytest.raises(ValueError, match="exact"):
        ops.SoftmaxSpec(kind="exact", fault=mild)


def test_config_specs_carry_the_fault():
    """``softmax_spec`` / ``attention_spec`` / ``paged_attention_spec`` fold a
    fault set on the config's ``softmax`` field, legacy overrides included,
    as the reference's do."""
    mild = tf.FaultModel(**MILD)
    cfg = get_smoke_config("granite_8b")
    cfg = dataclasses.replace(cfg, softmax=dataclasses.replace(cfg.softmax_spec, fault=mild,
                                                               mode="histogram"))
    for c in (cfg, dataclasses.replace(cfg, softmax_int_bits=5)):
        assert c.softmax_spec.fault == mild and c.softmax_spec.mode == "histogram"
        assert c.attention_spec.softmax == c.softmax_spec
        assert c.paged_attention_spec.softmax == c.softmax_spec
    assert cfg.attention_spec.impl == "xla"
    jcfg = jax_smoke_config("granite_8b")
    jcfg = dataclasses.replace(jcfg, softmax=dataclasses.replace(
        jcfg.softmax_spec, fault=jf.FaultModel(**MILD), mode="histogram"))
    assert jcfg.attention_spec.impl == cfg.attention_spec.impl
    assert jcfg.paged_attention_spec.impl == cfg.paged_attention_spec.impl


# ---------------------------------------------------------------------------
# realizations


@pytest.mark.parametrize("bits", FORMATS)
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_stuck_masks_and_cam_remap_bit_exact(name, bits):
    jfm, tfm = jf.FaultModel(**FAULTS[name]), tf.FaultModel(**FAULTS[name])
    jfmt, tfmt = JFmt(*bits), FixedPointFormat(*bits)
    for tag in ("softmax/cam", "matmul/w"):
        on_j, off_j = jf.stuck_masks(jf.fault_key(jfm, tag), (jfmt.num_levels, 3), jfm)
        on_t, off_t = tf.stuck_masks(tf.fault_key(tfm, tag), (tfmt.num_levels, 3), tfm)
        assert np.array_equal(on_t.numpy(), np.asarray(on_j))
        assert np.array_equal(off_t.numpy(), np.asarray(off_j))
    rj, rt = jf.cam_remap(jfmt, jfm), tf.cam_remap(tfmt, tfm)
    assert (rj is None) == (rt is None)
    if rt is not None:
        assert rt.dtype == torch.int32
        assert np.array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("bits", FORMATS)
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_faulty_luts_gain_and_offsets_close(name, bits):
    jfm, tfm = jf.FaultModel(**FAULTS[name]), tf.FaultModel(**FAULTS[name])
    jfmt, tfmt = JFmt(*bits), FixedPointFormat(*bits)
    for tag in ("softmax/lut", "softmax/vmm"):
        got = tf.faulty_exp_lut(tfmt, tfm, tag).numpy()
        ref = np.asarray(jf.faulty_exp_lut(jfmt, jfm, tag))
        assert _ulps(got, ref) <= ULPS
        assert np.array_equal(got == 0.0, ref == 0.0)  # stuck-off cells
    gj, gt = jf.adc_gain(jfm), tf.adc_gain(tfm)
    assert (gj is None) == (gt is None)
    if gt is not None:
        assert _ulps(gt, float(gj)) <= ULPS
    oj, ot = jf.adc_tile_offsets(jfm, (8, 5)), tf.adc_tile_offsets(tfm, (8, 5))
    assert (oj is None) == (ot is None)
    if ot is not None:
        assert _ulps(ot.numpy(), oj) <= ULPS
    w = np.random.default_rng(3).integers(-127, 128, (128, 256)).astype(np.float32)
    got = tf.apply_cell_faults(torch.from_numpy(w), tfm, "matmul/w", g_on=127.0).numpy()
    ref = np.asarray(jf.apply_cell_faults(jnp.asarray(w), jfm, "matmul/w", g_on=127.0))
    assert _ulps(got, ref) <= ULPS


def test_realization_is_computed_once_per_device():
    mild = tf.FaultModel(**MILD)
    fmt = FixedPointFormat(6, 2)
    a = tf.faulty_exp_lut(fmt, mild, "softmax/lut", device="cpu")
    assert tf.faulty_exp_lut(fmt, mild, "softmax/lut", device=torch.device("cpu")) is a
    assert tf.cam_remap(fmt, mild) is tf.cam_remap(fmt, mild)
    assert tf.cam_remap(fmt, tf.FaultModel(g_sigma=0.1)) is None  # no stuck cells
    assert tf.adc_gain(tf.FaultModel(g_sigma=0.1)) is None


# ---------------------------------------------------------------------------
# histogram counting (the repair: scatter-add, not a [..., d, L] one-hot)


@pytest.mark.parametrize("levels", [8, 256])
def test_histogram_counts_equal_the_reference(levels):
    rng = np.random.default_rng(levels)
    k = rng.integers(0, levels, (3, 5, 97)).astype(np.int32)
    mask = rng.random((3, 5, 97)) < 0.7
    ref = np.asarray(jax_lut.histogram_counts(jnp.asarray(k), levels))
    got = lut_lib.histogram_counts(torch.from_numpy(k), levels)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref)
    ref_w = np.asarray(jax_core_softmax._weighted_histogram(jnp.asarray(k), jnp.asarray(mask), levels))
    got_w = port_core_softmax._weighted_histogram(torch.from_numpy(k), torch.from_numpy(mask), levels)
    assert np.array_equal(got_w.numpy(), ref_w)
    ref_ax = np.asarray(jax_lut.histogram_counts(jnp.asarray(k), levels, axis=1))
    assert np.array_equal(lut_lib.histogram_counts(torch.from_numpy(k), levels, axis=1).numpy(), ref_ax)


# ---------------------------------------------------------------------------
# STAR softmax under faults


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["mild", "severe", "variation"])
def test_core_star_softmax_under_faults_matches_reference(name, mode, masked):
    x = _x(20, (4, 3, 96))
    where = np.random.default_rng(21).random((4, 1, 96)) < 0.8 if masked else None
    where_j = None if where is None else jnp.asarray(where)
    where_t = None if where is None else torch.from_numpy(where)
    fmt_j, fmt_t = JFmt(6, 3), FixedPointFormat(6, 3)
    ref = np.asarray(jax_core_softmax.star_softmax(
        jnp.asarray(x), fmt_j, mode=mode, where=where_j, fault=jf.FaultModel(**FAULTS[name])))
    got = port_core_softmax.star_softmax(
        torch.from_numpy(x), fmt_t, mode=mode, where=where_t, fault=tf.FaultModel(**FAULTS[name]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,mode", [("clean", "onehot"), ("clean", "histogram")] + [
    (name, mode) for name in ("mild", "severe") for mode in MODES])
def test_softmax_pallas_route_matches_the_pallas_kernels(name, mode, dtype):
    """``ops.softmax(impl="pallas")`` (the kernels' plain versions here)
    against ``star_softmax_pallas`` in interpret mode: ``_kernel`` for clean
    onehot / histogram (clean gather: ``tests/test_torch_kernels.py``),
    ``_kernel_faulty`` with and without the histogram."""
    x = torch.as_tensor(_x(22, (5, 2, 130))).to(getattr(torch, dtype))
    kw = FAULTS.get(name)
    ref = np.asarray(star_softmax_pallas(
        jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype)), fmt=JFmt(6, 2),
        use_histogram=mode == "histogram", use_mxu_lut=mode == "onehot",
        fault=jf.FaultModel(**kw) if kw else None, interpret=True))
    spec = ops.SoftmaxSpec(impl="pallas", mode=mode, fault=tf.FaultModel(**kw) if kw else None)
    got = ops.softmax(x, spec)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-12)


def test_onehot_is_the_gather_function():
    """A one-hot row with one nonzero reproduces the gathered entry, so the
    onehot mode needs no kernel of its own: bit-equal outputs."""
    x = torch.as_tensor(_x(23, (6, 257)))
    for fault in (None, tf.FaultModel(**MILD)):
        a = ops.softmax(x, ops.SoftmaxSpec(impl="pallas", mode="onehot", fault=fault))
        b = ops.softmax(x, ops.SoftmaxSpec(impl="pallas", mode="gather", fault=fault))
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# attention under faults


def _qkv(seed, b=2, tq=9, tk=9, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [(rng.integers(-16, 17, sh) / 8.0).astype(np.float32)
            for sh in ((b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d))]


@pytest.mark.parametrize("mode", MODES)
def test_attention_xla_under_fault_is_reference(mode):
    mild = tf.FaultModel(**MILD)
    q, k, v = (torch.from_numpy(a) for a in _qkv(30, tq=40, tk=40))
    soft = ops.SoftmaxSpec(mode=mode, fault=mild)
    spec = ops.AttentionSpec(impl="xla", softmax=soft, causal=True, block_kv=16)
    got = ops.attention(q, k, v, spec, kv_valid_len=torch.tensor([40, 23]))
    ref = ops.attention(q, k, v, dataclasses.replace(spec, impl="reference"),
                        kv_valid_len=torch.tensor([40, 23]))
    assert torch.equal(got, ref)  # the faulty call takes the materialized path
    qj, kj, vj = (jnp.asarray(a.numpy()) for a in (q, k, v))
    jref = jax_attention(qj, kj, vj, softmax=JaxSoftmaxConfig(
        kind="star", fmt=JFmt(6, 2), mode=mode, fault=jf.FaultModel(**MILD)),
        causal=True, kv_valid_len=jnp.asarray([40, 23]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="cannot inject cell faults"):
        blocked_attention(q, k, v, softmax=SoftmaxConfig.from_spec(soft))
    assert not torch.equal(got, attention(q, k, v, softmax=SoftmaxConfig(mode=mode), causal=True,
                                          kv_valid_len=torch.tensor([40, 23])))


def test_capability_errors_with_a_fault():
    mild = tf.FaultModel(**MILD)
    soft = ops.SoftmaxSpec(fault=mild)
    q, k, v = (torch.from_numpy(a) for a in _qkv(31))
    with pytest.raises(CapabilityError, match="softmax.fault"):
        ops.attention(q, k, v, ops.AttentionSpec(impl="pallas", softmax=soft))
    for impl in ("pallas", "pallas_paged"):
        with pytest.raises(CapabilityError, match="softmax.fault"):
            ops.validate(ops.PagedAttentionSpec(impl=impl, softmax=soft))
    with pytest.raises(CapabilityError):  # xla is the exact path only
        ops.softmax(torch.zeros(2, 4), ops.SoftmaxSpec(impl="xla", fault=mild))
    assert ops.get("softmax", "xla").capabilities["fault"] == (None,)
    with pytest.raises(ValueError, match="exact"):  # the exact kind refuses a fault
        ops.softmax(torch.zeros(2, 4), ops.SoftmaxSpec(kind="exact"), fault=mild)
    with pytest.raises(CapabilityError, match="fault"):
        ops.matmul(torch.zeros(2, 4), torch.zeros(4, 3), ops.MatmulSpec(fault=mild))


# ---------------------------------------------------------------------------
# the accuracy guard on the softmax, against the JAX guard


X_GUARD = _x(40, (4, 64), 3.0)


def _guarded_pair(config_kw, fault_kw, n_calls, impl="reference", mode="gather"):
    """Run the same guarded calls through both packages; return both stats."""
    jspec = jops.SoftmaxSpec(impl=impl, mode=mode, precision=JFmt(6, 3),
                             fault=jf.FaultModel(**fault_kw) if fault_kw else None)
    tspec = ops.SoftmaxSpec(impl=impl, mode=mode, precision=FixedPointFormat(6, 3),
                            fault=tf.FaultModel(**fault_kw) if fault_kw else None)
    jg = jops.AccuracyGuard(jops.GuardConfig(**config_kw))
    tg = ops.AccuracyGuard(ops.GuardConfig(**config_kw))
    outs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(n_calls):
            jo = np.asarray(jops.softmax(jnp.asarray(X_GUARD), jspec, guard=jg))
            to = ops.softmax(torch.from_numpy(X_GUARD), tspec, guard=tg).numpy()
            outs.append((jo, to))
    return jg.stats(), tg.stats(), outs


def _same_stats(js, ts):
    assert {k: v for k, v in js.items() if k != "last_error"} == \
        {k: v for k, v in ts.items() if k != "last_error"}
    assert (js["last_error"] is None) == (ts["last_error"] is None)
    if ts["last_error"] is not None:
        assert ts["last_error"] == pytest.approx(js["last_error"], rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_guard_trips_falls_back_and_latches(impl):
    js, ts, outs = _guarded_pair({}, SEVERE, 3, impl=impl, mode="histogram")
    _same_stats(js, ts)
    assert ts["trips"] == 1 and ts["tripped"] and ts["fallbacks"] == 3 and ts["checks"] == 1
    clean = port_core_softmax.star_softmax(torch.from_numpy(X_GUARD), FixedPointFormat(6, 3),
                                           mode="histogram").numpy()
    for jo, to in outs:  # every call served by the clean reference backend
        np.testing.assert_allclose(to, clean, rtol=0, atol=0)
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=1e-12)


def test_guard_sample_every_without_latch():
    js, ts, _ = _guarded_pair(dict(sample_every=3, latch=False), SEVERE, 6)
    _same_stats(js, ts)
    assert ts["calls"] == 6 and ts["checks"] == 2 and ts["trips"] == 2 and ts["fallbacks"] == 2


def test_guard_clean_spec_passes_through():
    js, ts, outs = _guarded_pair({}, None, 4, impl="pallas", mode="histogram")
    _same_stats(js, ts)
    assert ts["trips"] == 0 and not ts["tripped"] and ts["checks"] == 4
    unguarded = ops.softmax(torch.from_numpy(X_GUARD), ops.SoftmaxSpec(
        impl="pallas", mode="histogram", precision=FixedPointFormat(6, 3))).numpy()
    assert all(np.array_equal(to, unguarded) for _, to in outs)


def test_guard_trip_warning_is_structured_and_mirrored():
    from repro_torch.obs import metrics

    reg = metrics.MetricsRegistry()
    prev = metrics.set_default_registry(reg)
    try:
        g = ops.AccuracyGuard(ops.GuardConfig(tolerance=0.02))
        spec = ops.SoftmaxSpec(impl="pallas", fault=tf.FaultModel(**SEVERE))
        with pytest.warns(ops.GuardTripWarning) as rec:
            ops.softmax(torch.from_numpy(X_GUARD), spec, guard=g)
    finally:
        metrics.set_default_registry(prev)
    w = rec[0].message
    assert (w.op, w.impl, w.tolerance, w.fallback_impl) == ("softmax", "pallas", 0.02, "reference")
    assert w.error == g.last_error > 0.02
    assert reg.counter("ops.guard.trips").value(op="softmax", impl="pallas") == 1
    for event in ("calls", "checks", "fallbacks"):
        assert reg.counter(f"ops.guard.{event}").value(op="softmax") == 1


def test_guard_config_validation_and_pallas_fallback_refused():
    with pytest.raises(ValueError):
        ops.GuardConfig(sample_every=0)
    with pytest.raises(ValueError):
        ops.GuardConfig(tolerance=0.0)
    with pytest.raises(OpDispatchError, match="guard must be"):
        ops.softmax(torch.zeros(2, 4), guard="yes")
    spec = ops.SoftmaxSpec(impl="pallas", fault=tf.FaultModel(**SEVERE))
    with pytest.raises(OpDispatchError, match="fallback_impl='pallas'"):
        ops.softmax(torch.from_numpy(X_GUARD), spec, guard=ops.GuardConfig(fallback_impl="pallas"))
    # the reference crashes inside its kernel there (recorded in ROADMAP queue C)
    jspec = jops.SoftmaxSpec(impl="pallas", fault=jf.FaultModel(**SEVERE))
    with pytest.raises(AttributeError, match="num_levels"):
        jops.softmax(jnp.asarray(X_GUARD), jspec, guard=jops.GuardConfig(fallback_impl="pallas"))


# ---------------------------------------------------------------------------
# the engine


@pytest.fixture(scope="module")
def pair():
    cfg_j = jax_smoke_config("granite_8b")
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = get_smoke_config("granite_8b")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _faulty(cfg, fault, mode):
    return dataclasses.replace(cfg, softmax=dataclasses.replace(cfg.softmax_spec, fault=fault,
                                                                mode=mode))


def test_greedy_tokens_under_a_mild_fault_equal_the_reference(pair):
    """Faulty attention (xla -> the materialized reference path) over the
    paged cache, histogram mode, greedy: the same tokens as the JAX engine."""
    cfg_j, params_j, cfg_t, params_t = pair
    cfg_j = _faulty(cfg_j, jf.FaultModel(**MILD), "histogram")
    cfg_t = _faulty(cfg_t, tf.FaultModel(**MILD), "histogram")
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg_t.vocab_size, (n,)).astype(np.int32) for n in (5, 11, 8)]
    gens = [4, 3, 5]
    expected = JaxEngine(cfg_j, params_j, JaxConfig(
        num_slots=2, max_len=32, kv_layout="paged", kv_block_size=4)).serve(prompts, gens)
    eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
        num_slots=2, max_len=32, kv_layout="paged", kv_block_size=4), device="cpu")
    assert eng.serve(prompts, gens) == expected
    assert eng.stats()["guard"] is None
    # the fault is live in every attention row: prefill logits move
    tokens = torch.as_tensor(prompts[1], dtype=torch.int64)[None]
    faulty, _ = build_model(cfg_t).prefill(params_t, tokens, 16)
    clean, _ = build_model(get_smoke_config("granite_8b")).prefill(params_t, tokens, 16)
    assert not torch.equal(faulty, clean)


def test_engine_stats_surface_guard_counters(pair):
    """The port's copy of the reference's engine guard test: a severe fault
    trips the guard, which warns, falls back, latches and counts."""
    _, _, cfg_t, params_t = pair
    cfg = _faulty(cfg_t, tf.FaultModel(**SEVERE), "gather")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (6,)), rng.integers(0, cfg.vocab_size, (4,))]
    eng = ContinuousBatchingEngine(cfg, params_t, ContinuousConfig(
        num_slots=2, max_len=48, temperature=1.0, kv_layout="paged",
        guard=ops.GuardConfig(tolerance=0.02)),
        device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with ops.use(softmax="pallas"):
            outs = eng.serve(prompts, 4)
    assert all(len(o) == 4 for o in outs)
    assert sum(issubclass(w.category, ops.GuardTripWarning) for w in rec) == 1
    g = eng.stats()["guard"]
    assert g["trips"] == 1 and g["tripped"] and g["checks"] == 1
    # admissions (2) + one batched call per tick, all after the trip served clean
    assert g["calls"] == 2 + eng.ticks and g["fallbacks"] == g["calls"]
    assert eng.stats()["kv"]["layout"] == "paged" and eng.stats()["ticks"] >= 1


def test_guard_checks_every_sampling_call_without_latch(pair):
    _, _, cfg_t, params_t = pair
    cfg = _faulty(cfg_t, tf.FaultModel(**MILD), "histogram")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (7, 5, 9)]
    eng = ContinuousBatchingEngine(cfg, params_t, ContinuousConfig(
        num_slots=2, max_len=40, temperature=0.8, kv_layout="paged",
        guard=ops.GuardConfig(latch=False)),
        device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with ops.use(softmax="pallas"):
            outs = eng.serve(prompts, [5, 4, 6])
    g = eng.stats()["guard"]
    assert [len(o) for o in outs] == [5, 4, 6]
    assert g["calls"] == g["checks"] == 3 + eng.ticks
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
