"""The port's quantized KV storage against the JAX reference.

* ``core.kvquant``: ``encode``, ``quantize_blocks`` and ``row_scale`` give
  codes and scales **bit-exact** with ``repro.core.kvquant`` on the same
  numpy inputs (magnitudes 1e-3..1e3, all-zero blocks, values past the
  grid's edge, values within an ulp of powers of two); fp8 codes compare as
  bytes.  The roundtrip bounds of ``tests/test_kv_quant.py`` hold too.
* The quantized paged decode's plain version against the JAX
  ``paged_flash_attention(..., k_scale=, v_scale=, interpret=True)``:
  float32, STAR and exact.  Codes times power-of-two scales and dyadic q
  keep every dot product exact in float32, so no score can snap to a
  neighbouring STAR level between the two: outputs hold to ``atol=1e-5``,
  the tolerance of the fp paged test.
* The quantized writes — ``attention_block``'s decode write (the scale
  stamped on a block's first row, clipped reuse on later rows) and
  ``write_slot_paged`` (whole blocks) — leave pools whose codes and scales
  are bit-exact with the JAX pool, given the same K/V rows.
* ``cuda``-marked cases hold the CUDA kernel to its plain version on the
  card (they skip here).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.core import kvquant
from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.kernels.paged_attention import kernel as paged_mod

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core import kvquant as jkv
    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.paged_attention.kernel import paged_flash_attention as jax_paged
    from repro.models import layers as jlayers
    from repro.models.registry import build_model as jax_build_model
except ImportError:
    jnp = None

QUANT = ("int8", "fp8_e4m3")
ATOL = 1e-5


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs JAX (the reference)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bytes(codes) -> np.ndarray:
    """Codes of either package as raw bytes (fp8 has no numpy dtype here)."""
    if isinstance(codes, torch.Tensor):
        return kvquant.indexable(codes).numpy().view(np.uint8)
    return np.asarray(codes).view(np.uint8)


def _to_torch_codes(codes) -> torch.Tensor:
    """JAX codes -> the same bits as a torch int8 / float8_e4m3fn tensor."""
    arr = np.asarray(codes)
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy())
    return torch.from_numpy(arr.view(np.uint8).copy()).view(torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# inputs for the bit-exact cases


def _near_powers_of_two() -> np.ndarray:
    p = (2.0 ** np.arange(-14, 12)).astype(np.float32)
    vals = [p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf)),
            (p * 1.5).astype(np.float32)]
    v = np.concatenate(vals).astype(np.float32)
    return np.concatenate([v, -v])


def _inputs(kind: str) -> np.ndarray:
    """``[4, 8, 2, 16]`` blocks ([..., bs, H, D])."""
    rng = np.random.default_rng(21)
    shape = (4, 8, 2, 16)
    if kind.startswith("normal"):
        mag = float(kind.split("_")[1])
        return (rng.normal(size=shape) * mag).astype(np.float32)
    if kind == "zero_blocks":
        x = rng.normal(size=shape).astype(np.float32)
        x[1] = 0.0
        x[3, :, 1] = 0.0  # one all-zero (block, head)
        return x
    if kind == "wide_range":  # 1e-3 .. 1e3 inside every block
        return (rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)
    if kind == "near_pow2":
        v = _near_powers_of_two()
        return np.resize(v, shape).astype(np.float32)
    raise ValueError(kind)


KINDS = ["normal_1e-3", "normal_1", "normal_1e3", "zero_blocks", "wide_range", "near_pow2"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quantize_blocks_bit_exact(kv_dtype, kind, jax_ref):
    x = _inputs(kind)
    cj, sj = jkv.quantize_blocks(jnp.asarray(x), kv_dtype)
    ct, st = kvquant.quantize_blocks(torch.as_tensor(x), kv_dtype)
    assert ct.dtype == kvquant.storage_dtype(kv_dtype) and st.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(ct), _bytes(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_row_scale_bit_exact(kv_dtype, kind, jax_ref):
    x = _inputs(kind)[0]  # [bs, H, D] rows
    np.testing.assert_array_equal(
        kvquant.row_scale(torch.as_tensor(x), kv_dtype).numpy(),
        np.asarray(jkv.row_scale(jnp.asarray(x), kv_dtype)))


# encode with fixed scales: unit (the raw grid, values near powers of two
# land exactly where floor(log2|y|) changes), small (values run past +-127 /
# +-448 and clip) and an odd one (y is no longer dyadic)
ENCODE_SCALES = [1.0, 2.0 ** -7, 1.0 / 448.0, 0.3]


@pytest.mark.parametrize("scale", ENCODE_SCALES)
@pytest.mark.parametrize("kind", ["near_pow2", "wide_range"])
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_encode_bit_exact(kv_dtype, kind, scale, jax_ref):
    x = _inputs(kind)
    cj = jkv.encode(jnp.asarray(x), jnp.float32(scale), kv_dtype)
    ct = kvquant.encode(torch.as_tensor(x), torch.tensor(scale, dtype=torch.float32), kv_dtype)
    np.testing.assert_array_equal(_bytes(ct), _bytes(cj))
    assert not torch.isnan(ct.float()).any()  # the clip keeps e4m3 off NaN


def test_encode_clips_past_the_grid():
    x = torch.tensor([1000.0, -1000.0, 448.0, 127.4, -127.6])
    assert kvquant.encode(x, torch.tensor(1.0), "int8").tolist() == [127, -127, 127, 127, -127]
    assert kvquant.encode(x, torch.tensor(1.0), "fp8_e4m3").float().tolist()[:3] == [448, -448, 448]


@pytest.mark.parametrize("kv_dtype", QUANT)
@pytest.mark.parametrize("magnitude", [1e-3, 1.0, 30.0])
def test_roundtrip_error_bound(kv_dtype, magnitude):
    """The bounds of ``tests/test_kv_quant.py``: |decode(encode(x)) - x| <=
    scale / 2 (int8) or 16 * scale (fp8_e4m3), plus float32 rounding."""
    x = torch.as_tensor(np.random.default_rng(23).normal(size=(4, 16, 2, 32)) * magnitude,
                        dtype=torch.float32)
    codes, scale = kvquant.quantize_blocks(x, kv_dtype)
    assert codes.dtype == kvquant.storage_dtype(kv_dtype)
    assert scale.shape == (4, 2) and scale.dtype == torch.float32
    back = kvquant.decode(codes, scale[:, None, :, None])
    bound = 0.5 if kv_dtype == "int8" else 16.0
    limit = bound * scale[:, None, :, None] * (1 + 1e-5) + 1e-12
    assert bool(((back - x).abs() <= limit).all())


def test_dtype_plumbing_mirrors_the_reference(jax_ref):
    assert kvquant.KV_DTYPES == jkv.KV_DTYPES
    for name in QUANT:
        assert kvquant.qmax(name) == jkv.qmax(name)
        assert kvquant.dtype_of(kvquant.storage_dtype(name)) == name
    assert kvquant.dtype_of(torch.float32) == kvquant.dtype_of(torch.bfloat16) == "fp32"
    with pytest.raises(ValueError, match="fp32 KV pages"):
        kvquant.storage_dtype("fp32")
    with pytest.raises(ValueError, match="kv_dtype must be one of"):
        kvquant.validate_kv_dtype("int4")


# ---------------------------------------------------------------------------
# the quantized paged decode's plain version against the JAX Pallas kernel


def _quant_operands(rng, kv_dtype, s, w, bs, hq, hkv, d, lens):
    """Dyadic q, codes and power-of-two scales: every q.k is exact in f32
    whatever the summation order.  Codes come as numpy: int8, or float32
    values on the e4m3 grid."""
    n = s * w + 1
    q = (rng.integers(-16, 17, (s, hq, d)) / 8.0).astype(np.float32)
    if kv_dtype == "int8":
        kc, vc = (rng.integers(-127, 128, (n, bs, hkv, d)).astype(np.int8) for _ in range(2))
    else:
        vals = np.concatenate([2.0 ** np.arange(-3, 4), 1.5 * 2.0 ** np.arange(-3, 4)])
        vals = np.concatenate([vals, -vals]).astype(np.float32)
        kc, vc = (rng.choice(vals, (n, bs, hkv, d)) for _ in range(2))
    ks, vs = ((2.0 ** rng.integers(-7, -3, (n, hkv))).astype(np.float32) for _ in range(2))
    tables = rng.permutation(np.arange(1, n))[: s * w].reshape(s, w).astype(np.int32)
    return q, kc, vc, ks, vs, tables, np.asarray(lens, np.int32)


def _torch_codes(a: np.ndarray, device=None) -> torch.Tensor:
    t = torch.as_tensor(a, device=device)
    return t if a.dtype == np.int8 else t.to(torch.float8_e4m3fn)


def _jax_codes(a: np.ndarray):
    return jnp.asarray(a) if a.dtype == np.int8 else jnp.asarray(a).astype(jnp.float8_e4m3fn)


PAGED_CASES = [
    # s, w, bs, hq, hkv, lens  (a 0 is a free slot)
    (3, 4, 8, 4, 2, (6, 25, 0)),
    (4, 3, 16, 8, 2, (16, 17, 48, 1)),
    (2, 5, 8, 4, 4, (40, 9)),
]


@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quant_paged_plain_matches_pallas(kv_dtype, case, star, jax_ref):
    s, w, bs, hq, hkv, lens = case
    rng = np.random.default_rng(31)
    q, kc, vc, ks, vs, tables, kvl = _quant_operands(rng, kv_dtype, s, w, bs, hq, hkv, 16, lens)
    ref = np.asarray(jax_paged(
        jnp.asarray(q), _jax_codes(kc), _jax_codes(vc), jnp.asarray(tables), jnp.asarray(kvl),
        fmt=JFMT if star else None, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = paged_mod.paged_flash_attention(
        torch.as_tensor(q), _torch_codes(kc), _torch_codes(vc),
        torch.as_tensor(tables), torch.as_tensor(kvl),
        fmt=FMT if star else None, k_scale=torch.as_tensor(ks), v_scale=torch.as_tensor(vs))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    for i in np.flatnonzero(kvl == 0):
        assert not got[i].any()  # a free slot emits zeros


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quant_paged_plain_matches_pallas_on_quantized_normals(kv_dtype, jax_ref):
    """Codes and scales from ``quantize_blocks`` of normal K/V (the serving
    path's operands), exact softmax (no grid to flip): the same codes in
    both, outputs to float32 rounding."""
    s, w, bs, hq, hkv, d, lens = 3, 4, 8, 4, 2, 16, (6, 25, 0)
    rng = np.random.default_rng(32)
    n = s * w + 1
    q = rng.normal(size=(s, hq, d)).astype(np.float32)
    kf, vf = (rng.normal(size=(n, bs, hkv, d)).astype(np.float32) for _ in range(2))
    kc_j, ks = jkv.quantize_blocks(jnp.asarray(kf), kv_dtype)
    vc_j, vs = jkv.quantize_blocks(jnp.asarray(vf), kv_dtype)
    tables = rng.permutation(np.arange(1, n))[: s * w].reshape(s, w).astype(np.int32)
    kvl = np.asarray(lens, np.int32)
    ref = np.asarray(jax_paged(jnp.asarray(q), kc_j, vc_j, jnp.asarray(tables),
                               jnp.asarray(kvl), fmt=None, interpret=True,
                               k_scale=ks, v_scale=vs))
    got = paged_mod.paged_flash_attention(
        torch.as_tensor(q), _to_torch_codes(kc_j), _to_torch_codes(vc_j),
        torch.as_tensor(tables), torch.as_tensor(kvl), fmt=None,
        k_scale=torch.as_tensor(np.array(ks)), v_scale=torch.as_tensor(np.array(vs)))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=1e-5)


def test_paged_attention_dispatch_needs_scales_iff_quantized():
    z = torch.zeros(2, 1, 2, 16)
    pages = torch.zeros(3, 4, 2, 16, dtype=torch.int8)
    tables = torch.ones(2, 1, dtype=torch.int32)
    valid = torch.ones(2, dtype=torch.int32)
    scales = (torch.ones(3, 2), torch.ones(3, 2))
    spec = ops.PagedAttentionSpec(impl="reference", block_size=4, kv_dtype="int8")
    with pytest.raises(ops.OpDispatchError, match="missing"):
        ops.paged_attention(z, pages, pages, tables, spec, kv_valid_len=valid)
    with pytest.raises(ops.OpDispatchError, match="supplied"):
        ops.paged_attention(z, pages.float(), pages.float(), tables,
                            dataclasses.replace(spec, kv_dtype="fp32"),
                            kv_valid_len=valid, kv_scales=scales)
    for impl in ("reference", "xla", "pallas", "pallas_paged"):
        out = ops.paged_attention(z, pages, pages, tables, spec, kv_valid_len=valid,
                                  kv_scales=scales, impl=impl)
        assert out.shape == z.shape
    with pytest.raises(ValueError, match="kv_dtype must be one of"):
        ops.PagedAttentionSpec(kv_dtype="int4")
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_mod.paged_flash_attention(z[:, 0], pages, pages, tables, valid, fmt=FMT,
                                        k_scale=scales[0])


# ---------------------------------------------------------------------------
# quantized writes: bit-exact pools given the same K/V rows


def _smoke_pair():
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl="pallas")
    from repro_torch.configs import get_smoke_config

    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    return cfg_j, cfg_t


def _layer_params(rng, cfg_t):
    """Dyadic projection weights: with dyadic activations every q/k/v
    element is exact in float32 in both packages."""
    d, hd = cfg_t.d_model, cfg_t.resolved_head_dim
    shapes = {"wq": (d, cfg_t.num_heads * hd), "wk": (d, cfg_t.num_kv_heads * hd),
              "wv": (d, cfg_t.num_kv_heads * hd), "wo": (cfg_t.num_heads * hd, d)}
    return {k: (rng.integers(-4, 5, sh) / 16.0).astype(np.float32) for k, sh in shapes.items()}


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_decode_write_stamps_then_clips_bit_exact(kv_dtype, jax_ref, monkeypatch):
    """Four slots step through ``attention_block``'s paged decode write
    seven times at block size 4: slots start at rows 0, 3, 6 and 8, so
    rows 0, 4 and 8 stamp a fresh block's scale and the others reuse it;
    later rows grow in magnitude, so the reused stamps clip.  RoPE is held
    to the identity in both packages (its cos/sin differ between the
    two by float32 ulps) so both write the same K/V rows."""
    from repro_torch.models import layers as tlayers

    cfg_j, cfg_t = _smoke_pair()
    monkeypatch.setattr(jlayers, "apply_rope", lambda x, positions, theta: x)
    monkeypatch.setattr(tlayers, "apply_rope", lambda x, positions, theta: x)
    rng = np.random.default_rng(41)
    p = _layer_params(rng, cfg_t)
    s, w, bs, hkv, hd = 4, 4, 4, cfg_t.num_kv_heads, cfg_t.resolved_head_dim
    n = s * w + 1
    tables = rng.permutation(np.arange(1, n)).reshape(s, w).astype(np.int32)
    lens = np.array([0, 3, 6, 8], np.int32)
    dt = kvquant.storage_dtype(kv_dtype)
    pool_t = {"k": torch.zeros((n, bs, hkv, hd), dtype=dt),
              "v": torch.zeros((n, bs, hkv, hd), dtype=dt),
              "k_scale": torch.ones((n, hkv)), "v_scale": torch.ones((n, hkv))}
    jdt = jkv.storage_dtype(kv_dtype)
    pool_j = {"k": jnp.zeros((n, bs, hkv, hd), jdt), "v": jnp.zeros((n, bs, hkv, hd), jdt),
              "k_scale": jnp.ones((n, hkv), jnp.float32),
              "v_scale": jnp.ones((n, hkv), jnp.float32)}
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    for step in range(7):
        x = (rng.integers(-16, 17, (s, 1, cfg_t.d_model)) / 8.0 * (1 + step)).astype(np.float32)
        pos = lens[:, None]
        out_t, c_t, _ = tlayers.attention_block(
            pt, torch.as_tensor(x), cfg_t, positions=torch.as_tensor(pos),
            cache={**pool_t, "len": torch.as_tensor(lens), "tables": torch.as_tensor(tables)},
            paged_cache_t=w * bs)
        out_j, c_j, _ = jlayers.attention_block(
            pj, jnp.asarray(x), cfg_j, positions=jnp.asarray(pos),
            cache={**pool_j, "len": jnp.asarray(lens), "tables": jnp.asarray(tables)},
            paged_cache_t=w * bs)
        pool_j = {k: c_j[k] for k in pool_j}
        for name in ("k", "v"):
            np.testing.assert_array_equal(_bytes(c_t[name]), _bytes(c_j[name]))
            np.testing.assert_array_equal(c_t[f"{name}_scale"].numpy(),
                                          np.asarray(c_j[f"{name}_scale"]))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4, rtol=1e-5)
        lens = lens + 1
    # rows past a stamp clipped: some code sits at the grid's edge
    edge = 127 if kv_dtype == "int8" else 448
    assert float(pool_t["k"].float().abs().max()) == edge


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_write_slot_paged_quantizes_whole_blocks_bit_exact(kv_dtype, jax_ref):
    """The same batch-1 prefill cache scattered through a table with a
    repeated scratch entry gives the JAX pool's codes and scales."""
    from repro_torch.models.registry import build_model

    cfg_j, cfg_t = _smoke_pair()
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    rng = np.random.default_rng(42)
    nl, hkv, hd, t1 = cfg_t.num_layers, cfg_t.num_kv_heads, cfg_t.resolved_head_dim, 11
    kv = {n: (rng.normal(size=(nl, 1, 16, hkv, hd)) * 3).astype(np.float32) for n in "kv"}
    for a in kv.values():
        a[:, :, t1:] = 0.0
    table = np.array([3, 0, 5, 0], np.int32)  # scratch twice: a prefix-cache write
    pool_j = mj.init_paged_cache(7, 4, 2, kv_dtype=kv_dtype)
    pool_t = mt.init_paged_cache(7, 4, 2, device="cpu", kv_dtype=kv_dtype)
    cache_j = {"layers": {n: jnp.asarray(a) for n, a in kv.items()},
               "len": jnp.asarray(t1, jnp.int32), "pos": jnp.asarray(t1, jnp.int32)}
    cache_t = {"layers": {n: torch.as_tensor(a) for n, a in kv.items()},
               "len": torch.tensor(t1, dtype=torch.int32), "pos": torch.tensor(t1, dtype=torch.int32)}
    pool_j = mj.write_slot_paged(pool_j, cache_j, 1, jnp.asarray(table))
    mt.write_slot_paged(pool_t, cache_t, 1, torch.as_tensor(table))
    for blk in (1, 2, 3, 4, 5, 6):  # every block but scratch
        for name in ("k", "v"):
            np.testing.assert_array_equal(_bytes(pool_t["layers"][name][:, blk]),
                                          _bytes(pool_j["layers"][name][:, blk]))
            np.testing.assert_array_equal(pool_t["layers"][f"{name}_scale"][:, blk].numpy(),
                                          np.asarray(pool_j["layers"][f"{name}_scale"][:, blk]))
    assert pool_t["len"].tolist() == np.asarray(pool_j["len"]).tolist()
    # copy_block moves the scale rows with the codes
    mt.copy_block(pool_t, 3, 6)
    pool_j = mj.copy_block(pool_j, jnp.int32(3), jnp.int32(6))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(pool_t["layers"][name][:, 6])
                                      if name in "kv" else pool_t["layers"][name][:, 6].numpy(),
                                      _bytes(pool_j["layers"][name][:, 6])
                                      if name in "kv" else np.asarray(pool_j["layers"][name][:, 6]))


@pytest.mark.parametrize("kv_dtype", QUANT)
def test_gather_prefix_cache_dequantizes_like_the_reference(kv_dtype, jax_ref):
    from repro_torch.models.registry import build_model

    cfg_j, cfg_t = _smoke_pair()
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    rng = np.random.default_rng(43)
    kv = {n: rng.normal(size=(cfg_t.num_layers, 1, 12, cfg_t.num_kv_heads,
                              cfg_t.resolved_head_dim)).astype(np.float32) for n in "kv"}
    table = np.array([2, 5, 1], np.int32)
    pool_j = mj.write_slot_paged(
        mj.init_paged_cache(6, 4, 1, kv_dtype=kv_dtype),
        {"layers": {n: jnp.asarray(a) for n, a in kv.items()},
         "len": jnp.int32(12), "pos": jnp.int32(12)}, 0, jnp.asarray(table))
    pool_t = mt.write_slot_paged(
        mt.init_paged_cache(6, 4, 1, device="cpu", kv_dtype=kv_dtype),
        {"layers": {n: torch.as_tensor(a) for n, a in kv.items()},
         "len": torch.tensor(12, dtype=torch.int32), "pos": torch.tensor(12, dtype=torch.int32)},
        0, torch.as_tensor(table))
    got = mt.gather_prefix_cache(pool_t, [2, 5], 8, 16)
    want = mj.gather_prefix_cache(pool_j, [2, 5], 8, 16)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got["layers"][name].numpy(), np.asarray(want["layers"][name]))
    assert int(got["len"]) == int(want["len"]) == 8


# ---------------------------------------------------------------------------
# on the card: the quantized kernel against its plain version


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("kv_dtype", QUANT)
def test_quant_paged_kernel_matches_plain_on_card(cuda, kv_dtype, star, dtype):
    """Exact operands (dyadic q, codes, power-of-two scales), so the kernel
    and the plain version differ only in rounding the output."""
    rng = np.random.default_rng(33)
    before = paged_mod.LAUNCHES_QUANT.count
    for s, w, bs, hq, hkv, lens in PAGED_CASES:
        for d in (16, 64, 128):
            q, kc, vc, ks, vs, tables, kvl = (
                _quant_operands(rng, kv_dtype, s, w, bs, hq, hkv, d, lens))
            q = torch.as_tensor(q, device=cuda).to(dtype)
            kc, vc = _torch_codes(kc, cuda), _torch_codes(vc, cuda)
            ks, vs, tables, kvl = (torch.as_tensor(a, device=cuda) for a in (ks, vs, tables, kvl))
            kw = dict(fmt=FMT if star else None, k_scale=ks, v_scale=vs)
            got = paged_mod.paged_flash_attention(q, kc, vc, tables, kvl, **kw)
            ref = paged_mod.paged_attention_ref(q, kc, vc, tables, kvl, **kw)
            tol = dict(atol=8e-3, rtol=8e-3) if dtype == torch.bfloat16 else dict(atol=ATOL, rtol=1e-5)
            torch.testing.assert_close(got.float(), ref.float(), **tol)
            assert not got[kvl == 0].any()
    assert paged_mod.LAUNCHES_QUANT.count - before == 3 * len(PAGED_CASES)
