"""The port's STAR numerics against ``repro.core`` on shared numpy inputs.

Grid indices and LUT entries are bit-exact; probabilities and attention
outputs hold to float32 rounding (``rtol=1e-5, atol=1e-6``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# by module path: ``repro.core`` re-exports functions under the module names
jattn = importlib.import_module("repro.core.attention")
jfp = importlib.import_module("repro.core.fixedpoint")
jlut = importlib.import_module("repro.core.lut")
jss = importlib.import_module("repro.core.star_softmax")
tattn = importlib.import_module("repro_torch.core.attention")
tfp = importlib.import_module("repro_torch.core.fixedpoint")
tlut = importlib.import_module("repro_torch.core.lut")
tss = importlib.import_module("repro_torch.core.star_softmax")

RTOL, ATOL = 1e-5, 1e-6
FORMATS = [(6, 2), (6, 3), (5, 2), (3, 0)]


def _logits(seed, shape, scale=4.0, specials=True):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    if specials:
        flat = x.reshape(-1)
        flat[:4] = [np.inf, -np.inf, np.nan, 1e30]
        flat[4:8] = [0.125, -0.375, 2.5 / 4, -1.5 / 4]  # exact half-steps at (6,2)
    return x


@pytest.mark.parametrize("bits", FORMATS)
def test_quantize_logits_and_grid_index_bit_exact(bits):
    fj, ft = jfp.FixedPointFormat(*bits), tfp.FixedPointFormat(*bits)
    x = _logits(0, (6, 33))
    jj = np.asarray(jfp.quantize_logits(jnp.asarray(x), fj))
    jt = tfp.quantize_logits(torch.as_tensor(x), ft)
    assert jt.dtype == torch.int32
    np.testing.assert_array_equal(jt.numpy(), jj)
    mj = jj.max(axis=-1, keepdims=True)
    kj = np.asarray(jfp.grid_index(jnp.asarray(jj), jnp.asarray(mj), fj))
    kt = tfp.grid_index(jt, jt.amax(dim=-1, keepdim=True), ft)
    np.testing.assert_array_equal(kt.numpy(), kj)
    assert tfp.GRID_SENTINEL == jfp.GRID_SENTINEL
    assert (ft.num_levels, ft.scale, ft.min_value) == (fj.num_levels, fj.scale, fj.min_value)


@pytest.mark.parametrize("bits", FORMATS)
def test_lut_and_lookups_bit_exact(bits):
    fj, ft = jfp.FixedPointFormat(*bits), tfp.FixedPointFormat(*bits)
    tj = np.asarray(jlut.exp_lut(fj))
    tt = tlut.exp_lut(ft)
    np.testing.assert_array_equal(tt.numpy(), tj)
    k = np.random.default_rng(1).integers(0, ft.num_levels, (5, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        tlut.lookup_gather(torch.as_tensor(k), tt).numpy(),
        np.asarray(jlut.lookup_gather(jnp.asarray(k), jnp.asarray(tj))))
    np.testing.assert_array_equal(
        tlut.lookup_onehot(torch.as_tensor(k), tt).numpy(),
        np.asarray(jlut.lookup_onehot(jnp.asarray(k), jnp.asarray(tj))))
    cj = np.asarray(jlut.histogram_counts(jnp.asarray(k), fj.num_levels))
    ct = tlut.histogram_counts(torch.as_tensor(k), ft.num_levels)
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_allclose(tlut.histogram_dot(ct, tt).numpy(),
                               np.asarray(jlut.histogram_dot(jnp.asarray(cj), jnp.asarray(tj))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["gather", "onehot", "histogram"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("axis", [-1, 1])
def test_star_softmax_matches_reference(mode, masked, axis):
    x = _logits(2, (3, 17, 24))
    where = None
    if masked:
        where = np.random.default_rng(3).random((3, 17, 24)) > 0.3
        where[0, 0] = False  # a fully masked row -> zeros
    pj = np.asarray(jss.star_softmax(
        jnp.asarray(x), jfp.DEFAULT_FORMAT, axis=axis, mode=mode,
        where=None if where is None else jnp.asarray(where)))
    pt = tss.star_softmax(
        torch.as_tensor(x), tfp.DEFAULT_FORMAT, axis=axis, mode=mode,
        where=None if where is None else torch.as_tensor(where))
    assert pt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), pj, rtol=RTOL, atol=ATOL)


def test_exact_softmax_matches_reference():
    x = _logits(4, (4, 31), specials=False)
    np.testing.assert_allclose(tss.exact_softmax(torch.as_tensor(x)).numpy(),
                               np.asarray(jss.exact_softmax(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_neg_inf_columns_take_the_last_level():
    x = torch.tensor([[0.0, 1.0, -float("inf"), -float("inf")]])
    p = tss.star_softmax(x, tfp.DEFAULT_FORMAT, mode="gather")
    last = float(np.exp(-255 / 4))
    # the row max holds probability 1 / (1 + e^-1) = 0.7310586 of the LUT mass
    np.testing.assert_allclose(p.numpy(), [[0.2689414, 0.7310586, last * 0.7310586,
                                            last * 0.7310586]],
                               rtol=1e-5, atol=0)


def _dyadic(seed, shape):
    # multiples of 1/8 in [-2, 2]: every q.k dot product is exact in
    # float32 in any summation order, so no score can land on the other
    # side of a grid half-step between two implementations
    return (np.random.default_rng(seed).integers(-16, 17, shape) / 8.0).astype(np.float32)


ATTN_CASES = [
    # b, tq, tk, hq, hkv, causal, window, q_offset, ragged
    (1, 13, 13, 4, 2, True, None, 0, False),
    (2, 9, 21, 8, 2, True, None, 12, True),
    (2, 7, 19, 4, 4, False, None, 0, True),
    (1, 16, 16, 4, 1, True, 5, 0, False),
]


@pytest.mark.parametrize("kind", ["star", "exact"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_and_blocked_match_reference(kind, case):
    b, tq, tk, hq, hkv, causal, window, q_offset, ragged = case
    d = 16
    q, k, v = _dyadic(5, (b, tq, hq, d)), _dyadic(6, (b, tk, hkv, d)), _dyadic(7, (b, tk, hkv, d))
    kvl = np.array([tk - 3 * i for i in range(b)], np.int32) if ragged else None
    smj = jattn.SoftmaxConfig(kind=kind)
    smt = tattn.SoftmaxConfig(kind=kind)
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    ref = np.asarray(jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), softmax=smj,
        kv_valid_len=None if kvl is None else jnp.asarray(kvl), **kw))
    tq_, tk_, tv_ = torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v)
    tkvl = None if kvl is None else torch.as_tensor(kvl)
    full = tattn.attention(tq_, tk_, tv_, softmax=smt, kv_valid_len=tkvl, **kw)
    np.testing.assert_allclose(full.numpy(), ref, rtol=RTOL, atol=1e-5)
    # the online form equals the two-pass engine to float32 rounding
    blocked = tattn.blocked_attention(tq_, tk_, tv_, softmax=smt, kv_valid_len=tkvl,
                                      block_size=8, **kw)
    np.testing.assert_allclose(blocked.numpy(), ref, rtol=RTOL, atol=1e-5)
