"""flash_star's float32 kernel and its int8 P.V variant on the tensor cores.

The float32 kernel forms every product as 3xTF32 (each float32 operand
split into tf32 hi and lo, ``ref.split_tf32``; hi.hi + hi.lo + lo.hi into a
float32 accumulator), over 32-row KV tiles.  The int8 variant quantizes V
once per block in a pre-pass (``ref.quantize_v_blocks``) into a workspace
whose 32-key groups are in the order of ``ref.v8_perm``, and runs P.V on s8
tensor-core products.  Here, with no card:

* the 3xTF32 product of two float32 vectors of length 128 is within the
  float32 dot's own error bound of the float64 dot, and one tf32 rounding
  of each operand is more than ten times outside it;
* the pre-pass's codes and scales equal the JAX kernel's expressions
  (``jnp.round(vf * (127.0 / vamax))``, ``vamax / (127.0 * 127.0)``) bit for
  bit, on rounding ties and a ragged last block;
* the s8 P.V as the kernel's fragments form it (each lane packs the p8 of
  its own score registers, the codes in ``v8_perm`` order, the PTX
  m16n8k32 fragment layout) equals the plain int32 product bit for bit for
  bk in {16, 20, 64, 100, 128};
* a float32 emulation of the new tile loop (32-row tiles, 3xTF32 products,
  the softmax's arithmetic) matches the JAX kernel in interpret mode at D 16
  and 128 (atol 1e-5: float32 sums in another order);
* the wrapper through a fake library: the workspace's shapes from the
  shapes alone.

``cuda``-marked tests (skipped here) hold each new kernel to its plain
version on the card: the float32 kernel at every head dimension, the
pre-pass bit for bit, and the int8 variant's outputs.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.core.lut import exp_lut

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
except ImportError:
    jnp = None

flash_mod = importlib.import_module("repro_torch.kernels.flash_star.kernel")
ref_mod = importlib.import_module("repro_torch.kernels.flash_star.ref")

TILE = 32  # the float32 kernel's KV rows per tile


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


def _tf32_rounded(x):
    return ref_mod.split_tf32(x)[0]


def _prod3(a, b):
    """a @ b as the float32 kernel forms it: lo.hi + hi.lo + hi.hi of the
    tf32 pieces, each product exact in float64, summed in float32."""
    ah, al = ref_mod.split_tf32(a)
    bh, bl = ref_mod.split_tf32(b)
    out = (al.double() @ bh.double()).float()
    out = out + (ah.double() @ bl.double()).float()
    return out + (ah.double() @ bh.double()).float()


# ---------------------------------------------------------------------------
# (a) 3xTF32


def test_split_tf32_pieces_are_tf32_and_sum_close_to_x():
    rng = np.random.default_rng(40)
    x = torch.as_tensor(rng.normal(size=100_000) * 10.0 ** rng.uniform(-6, 6, 100_000),
                        dtype=torch.float32)
    hi, lo = ref_mod.split_tf32(x)
    for piece in (hi, lo):  # 10 mantissa bits: the low 13 bits are zero
        assert int((piece.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def test_split_tf32_rounds_ties_away_from_zero():
    """cvt.rna: 1 + 2^-11 (half a tf32 ulp above 1) rounds up, -(1 + 2^-11)
    down; 1 + 2^-11 - 2^-23 rounds to 1."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23])
    hi, _ = ref_mod.split_tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("kind", ["scores", "pv"])
def test_3xtf32_product_is_float32_faithful_at_d128(kind):
    """Q K^T rows of 128 (normal operands) and P V over 128 keys (P a
    softmax row, V normal): 3xTF32 stays within gamma_K sum |a b| of the
    float64 dot (gamma_K = K 2^-24, the float32 dot's own bound); one tf32
    rounding of each operand misses that bound more than tenfold."""
    rng = np.random.default_rng(41)
    k = 128
    if kind == "scores":
        a = torch.as_tensor(rng.normal(size=(64, k)), dtype=torch.float32)
    else:
        s = torch.as_tensor(rng.normal(size=(64, k)) * 2, dtype=torch.float32)
        a = torch.exp(s - s.amax(-1, keepdim=True))
    b = torch.as_tensor(rng.normal(size=(k, 64)), dtype=torch.float32)
    exact = a.double() @ b.double()
    bound = k * 2.0 ** -24 * (a.double().abs() @ b.double().abs())
    three = (_prod3(a, b).double() - exact).abs()
    one = ((_tf32_rounded(a).double() @ _tf32_rounded(b).double()) - exact).abs()
    assert bool((three <= bound).all())
    assert float((one / bound).max()) > 10


# ---------------------------------------------------------------------------
# (b) the V pre-pass against the JAX kernel's expressions


def _jax_codes(v, bk):
    """The TPU kernel's per-block codes and scale (kernel.py:135-141) on the
    zero-padded block, in jnp."""
    b, h, tk, d = v.shape
    nblk = -(-tk // bk)
    vp = jnp.pad(jnp.asarray(v), ((0, 0), (0, 0), (0, nblk * bk - tk), (0, 0)))
    codes, scales = [], []
    for i in range(nblk):
        vf = vp[:, :, i * bk:(i + 1) * bk].astype(jnp.float32)
        vamax = jnp.maximum(jnp.max(jnp.abs(vf), axis=(2, 3), keepdims=True), 1e-6)
        codes.append(jnp.round(vf * (127.0 / vamax)).astype(jnp.int8))
        scales.append((vamax / (127.0 * 127.0))[:, :, 0, 0])
    return np.concatenate([np.asarray(c) for c in codes], axis=2), np.stack(
        [np.asarray(s) for s in scales], axis=2)


@pytest.mark.parametrize("tk,bk", [(128, 128), (100, 64), (29, 16), (300, 128), (20, 20)])
def test_quantize_v_blocks_equals_the_jax_kernel(tk, bk, jax_ref):
    rng = np.random.default_rng(42)
    v = rng.normal(size=(2, 2, tk, 16)).astype(np.float32)
    v[0, 0, -1] *= 8.0  # the last (ragged) block's absmax in its last row
    got_codes, got_scales = ref_mod.quantize_v_blocks(torch.as_tensor(v), bk)
    want_codes, want_scales = _jax_codes(v, bk)
    np.testing.assert_array_equal(got_codes.numpy(), want_codes)
    np.testing.assert_array_equal(got_scales.numpy().view(np.int32), want_scales.view(np.int32))


def test_quantize_v_blocks_rounds_ties_like_the_jax_kernel(jax_ref):
    """vamax 1.875 puts v = 0.9375 at 63.5 and v = 0.5625 at 38.1: IEEE
    127 / vamax gives 63 at the tie (a reciprocal multiply would give 64)."""
    rng = np.random.default_rng(43)
    v = rng.choice(np.array([-1.875, -0.9375, 0.9375, 1.875, 0.5625, 0.0], np.float32),
                   size=(1, 2, 70, 16))
    got_codes, got_scales = ref_mod.quantize_v_blocks(torch.as_tensor(v), 32)
    want_codes, want_scales = _jax_codes(v, 32)
    assert 63 in np.abs(want_codes)
    np.testing.assert_array_equal(got_codes.numpy(), want_codes)
    np.testing.assert_array_equal(got_scales.numpy(), want_scales)


# ---------------------------------------------------------------------------
# (c) the s8 P.V through the kernel's fragments


def _pack_keys(t):
    """The keys (within a 32-key step) whose p8 lane t's pack_p8 puts in
    bytes 0..3 of its A registers a0 / a1; a2 / a3 hold these + 16: score
    n-tiles j, j + 1 of the step, elements 0, 1 (columns 2 t, 2 t + 1)."""
    return [2 * t, 2 * t + 1, 8 + 2 * t, 8 + 2 * t + 1]


def _fragment_pv(p8, v8, kpad):
    """One warp's s8 P.V as the kernel issues it.  p8 [16, kpad]: the warp's
    16 rows of one block's p codes in key order; v8 [D, kpad]: the block in
    the workspace layout.  Per k-step of 32 keys and n-tile of 8 features,
    every lane's registers are filled as the kernel fills them (A from its
    own score registers, B from the bytes its ldmatrix hands it: row g,
    bytes 4 t .. 4 t + 3 of each 16-byte half), placed where PTX's m16n8k32
    layout says they belong, and multiplied."""
    d = v8.shape[0]
    out = np.zeros((16, d), np.int64)
    for kk in range(kpad // 32):
        for n in range(d // 8):
            a = np.zeros((16, 32), np.int64)
            b = np.zeros((32, 8), np.int64)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for i, key in enumerate(_pack_keys(t)):
                    a[g, 4 * t + i] = p8[g, 32 * kk + key]             # a0
                    a[g + 8, 4 * t + i] = p8[g + 8, 32 * kk + key]     # a1
                    a[g, 16 + 4 * t + i] = p8[g, 32 * kk + 16 + key]   # a2
                    a[g + 8, 16 + 4 * t + i] = p8[g + 8, 32 * kk + 16 + key]  # a3
                    b[4 * t + i, g] = v8[8 * n + g, 32 * kk + 4 * t + i]        # b0
                    b[16 + 4 * t + i, g] = v8[8 * n + g, 32 * kk + 16 + 4 * t + i]  # b1
            out[:, 8 * n:8 * n + 8] += a @ b
    return out


@pytest.mark.parametrize("bk", [16, 20, 64, 100, 128])
def test_permuted_s8_pv_equals_the_plain_int32_product(bk):
    """Codes from the plain pre-pass in the workspace layout, p8 of a
    softmax row block (zero past bk): the fragment-level product is the
    plain p8 @ v8 bit for bit; without the permutation it is not."""
    rng = np.random.default_rng(44)
    d = 32
    v = torch.as_tensor(rng.normal(size=(1, 1, bk, d)), dtype=torch.float32)
    codes, _ = ref_mod.quantize_v_blocks(v, bk)
    v8 = ref_mod.v8_layout(codes, bk)[0, 0, 0].numpy().astype(np.int64)
    kpad = v8.shape[1]
    assert kpad == -(-bk // 32) * 32
    s = rng.normal(size=(16, bk)) * 2
    p = np.exp(s - s.max(-1, keepdims=True)).astype(np.float32)
    p8 = np.zeros((16, kpad), np.int64)
    p8[:, :bk] = np.rint(p * np.float32(127.0))
    want = p8[:, :bk] @ codes[0, 0].numpy().astype(np.int64)
    np.testing.assert_array_equal(_fragment_pv(p8, v8, kpad), want)
    natural = np.zeros_like(v8)
    natural[:, :bk] = codes[0, 0].numpy().T
    assert not np.array_equal(_fragment_pv(p8, natural, kpad), want)


def test_v8_layout_pads_each_feature_with_zero_codes():
    v = torch.ones(1, 2, 45, 16)
    codes, scales = ref_mod.quantize_v_blocks(v, 20)
    lay = ref_mod.v8_layout(codes, 20)
    assert lay.shape == (1, 2, 3, 16, 32) and lay.dtype == torch.int8
    assert torch.equal(scales, torch.full((1, 2, 3), 1.0 / 16129.0))
    perm = ref_mod.v8_perm()
    for blk, rows in enumerate((20, 20, 5)):
        live = (perm < rows).expand(16, 32)
        assert bool((lay[0, 0, blk][live] == 127).all())
        assert bool((lay[0, 0, blk][~live] == 0).all())


# ---------------------------------------------------------------------------
# (d) the float32 kernel's tile loop against the JAX kernel


def _tc_tile_loop(q, k, v, info, fmt, causal, window):
    """The float32 kernel's loop in float32 on the CPU: 32-row KV tiles,
    scores and P.V as 3xTF32 products (``_prod3``), s = fl(acc * sm_scale),
    the STAR grid index rint(fl(s * scale)), the int32 max, LUT (or expf)
    r and p, l = l r + sum p, o = o r + P V, and o / l at the end.  Tiles
    that the kernel skips contribute p = 0, r = 1 here (an exact no-op)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    kf, vf = (x.repeat_interleave(hq // hkv, 1) for x in (k, v))
    rows = int(info[0]) + torch.arange(tq)[:, None]
    valid = info[1:].long()[:, None, None, None]
    sent = -(1 << 24)
    if fmt is not None:
        lut, top = exp_lut(fmt), fmt.num_levels - 1
        m = torch.full((b, hq, tq), sent, dtype=torch.int64)
    else:
        m = torch.full((b, hq, tq), -1e30)
    l, o = torch.zeros(b, hq, tq), torch.zeros(b, hq, tq, d)
    for c0 in range(0, tk, TILE):
        kt, vt = kf[:, :, c0:c0 + TILE], vf[:, :, c0:c0 + TILE]
        cols = c0 + torch.arange(kt.shape[2])[None, :]
        live = (cols < valid) & ((cols <= rows) if causal else True)
        if window is not None:
            live = live & (cols > rows - window)
        live = live.expand(b, hq, tq, kt.shape[2])
        s = _prod3(q, kt.transpose(-1, -2)) * np.float32(d ** -0.5)
        if fmt is not None:
            jg = torch.where(live, torch.round(s * fmt.scale).long(), torch.tensor(sent))
            m_new = torch.maximum(m, jg.amax(-1))
            r = lut[(m_new - m).clamp(max=top)]
            p = torch.where(live, lut[(m_new[..., None] - jg).clamp(0, top)], 0.0)
        else:
            m_new = torch.maximum(m, torch.where(live, s, -1e30).amax(-1))
            r = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
        m = m_new
        l = l * r + p.sum(-1)
        o = o * r[..., None] + _prod3(p, vt)
    return o / torch.where(l <= 0, 1.0, l)[..., None]


EMU_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 4, 2, 70, 70, True, None, 0, None),        # 3 tiles, the last of 6 rows
    (2, 4, 2, 40, 100, True, None, 60, (100, 75)),  # q_offset, ragged
    (1, 4, 4, 64, 64, True, 20, 0, None),          # sliding window
    (2, 4, 2, 19, 45, False, None, 0, (45, 6)),    # non-causal, ragged
]


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", EMU_CASES)
def test_tf32_tile_loop_matches_pallas(case, star, d, jax_ref):
    """Dyadic q and k (every score exact, so no grid level differs), normal
    v: the emulated tile loop within atol 1e-5 of the JAX kernel."""
    b, hq, hkv, tq, tk, causal, window, q_off, kvl = case
    rng = np.random.default_rng(48)
    q = (rng.integers(-16, 17, (b, hq, tq, d)) / 8.0).astype(np.float32)
    k = (rng.integers(-16, 17, (b, hkv, tk, d)) / 8.0).astype(np.float32)
    v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    info = np.array([q_off] + list(kvl or [tk] * b), np.int32)
    want = np.asarray(jax_flash(
        *map(jnp.asarray, (q, k, v, info)), fmt=JFMT if star else None, causal=causal,
        sliding_window=window, block_q=64, block_k=64, interpret=True))
    got = _tc_tile_loop(*map(torch.as_tensor, (q, k, v, info)), FMT if star else None,
                        causal, window)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# (e) the wrapper


@pytest.mark.parametrize("tk,bk", [(512, 128), (500, 128), (29, 16), (20, 20), (300, 100)])
def test_workspace_is_sized_from_the_shapes(tk, bk):
    codes, scales = ref_mod.quantize_v_blocks(torch.zeros(2, 3, tk, 16), bk)
    code_shape, scale_shape = flash_mod.v8_shape(2, 3, tk, 16, bk)
    assert tuple(ref_mod.v8_layout(codes, bk).shape) == code_shape
    assert tuple(scales.shape) == scale_shape
    assert code_shape[-1] % 32 == 0 and code_shape[-1] - bk < 32


def test_source_constants_match_the_wrapper():
    """The kernel's k-group (its int8 sub-tile and the workspace's padding)
    is the plain layout's; no block size is capped, in the source or the
    wrapper (the attention kernel walks a block in 32-key sub-tiles, twice)."""
    src = flash_mod.SOURCE.read_text()
    assert f"constexpr int V8_GROUP = {ref_mod.V8_GROUP};" in src and ref_mod.V8_GROUP == 32
    assert "return (bk + 31) / 32 * 32;" in src
    assert "BK8" not in src and not hasattr(flash_mod, "PV_INT8_MAX_BLOCK")
    assert "static constexpr int SUB = PV8 ? V8_GROUP" in src
    assert "if (bk < 1 || (dtype != 0 && dtype != 1))" in src


# ---------------------------------------------------------------------------
# on the card: each new kernel against its plain version

CARD_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 4, 2, 13, 13, True, None, 0, None),           # T not a multiple of a tile
    (2, 8, 2, 9, 29, True, None, 20, (29, 17)),       # q_offset, ragged, GQA 8:2
    (2, 4, 2, 19, 19, False, None, 0, (19, 6)),       # ragged, non-causal
    (1, 4, 2, 200, 200, True, 50, 0, None),           # sliding window across tiles
    (2, 4, 2, 65, 265, True, None, 200, (265, 190)),  # q_offset, ragged, several q blocks
    (1, 32, 8, 130, 130, True, None, 0, None),        # GQA 32:8
]


def _normal_operands(case, d, dev, seed):
    b, hq, hkv, tq, tk, causal, window, q_off, kvl = case
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=g).to(dev) for sh in
               ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))
    info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32, device=dev)
    return q, k, v, info, dict(causal=causal, sliding_window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_tf32_kernel_matches_plain_on_card(cuda, star):
    """float32 q/k/v with normal entries (scores not exact in any order):
    the 3xTF32 kernel within 1e-5 + 1e-5 |plain| of the plain version,
    except rows whose grid index a float32 summation order can flip (a
    score within 1e-3 grid units of a half-step, STAR), one launch a call."""
    fmt = FMT if star else None
    for case in CARD_CASES:
        for d in (16, 32, 64, 128):
            q, k, v, info, kw = _normal_operands(case, d, cuda, seed=45)
            before = flash_mod.LAUNCHES.count
            got = flash_mod.flash_star_attention(q, k, v, info, fmt=fmt, **kw)
            assert flash_mod.LAUNCHES.count == before + 1
            ref = flash_mod.flash_star_ref(q, k, v, info, fmt=fmt, **kw)
            bad = ((got - ref).abs() > 1e-5 + 1e-5 * ref.abs()).any(-1)
            if star and bool(bad.any()):
                g = q.shape[1] // k.shape[1]
                s = (q.double() @ k.double().repeat_interleave(g, 1).transpose(-1, -2))
                frac = s * d ** -0.5 * FMT.scale
                near = ((frac - frac.floor() - 0.5).abs() < 1e-3).any(-1)
                bad = bad & ~near
            assert not bool(bad.any()), (case, d, float((got - ref).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk,bk", [(128, 128), (100, 64), (29, 16), (300, 128), (20, 20),
                                   (500, 100)])
def test_quantize_v_kernel_is_the_plain_pre_pass_bit_for_bit(cuda, dtype, tk, bk):
    g = torch.Generator().manual_seed(46)
    v = torch.randn((2, 3, tk, 128), generator=g)
    v[1, 2, -1] *= 8.0
    v = v.to(cuda, dtype)
    lib = flash_mod._cuda.load(flash_mod.SOURCE, flash_mod._bind)
    codes, scales = flash_mod._quantize_v(lib, v, bk, flash_mod._cuda.stream_handle(cuda))
    want_codes, want_scales = ref_mod.quantize_v_blocks(v, bk)
    assert torch.equal(codes, ref_mod.v8_layout(want_codes, bk))
    assert torch.equal(scales, want_scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_pv_int8_tensor_core_kernel_matches_plain_on_card(cuda, dtype, star):
    """Dyadic q and k (every score exact, so the codes are equal): outputs
    within float32 rounding of the plain version (bf16: two bf16 ulps), at
    blocks of 16 to 128 rows, one count for the pre-pass and the attention."""
    tol = dict(atol=8e-3, rtol=8e-3) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-5)
    fmt = FMT if star else None
    rng = np.random.default_rng(47)
    for case in CARD_CASES:
        for d in (16, 128):
            for bk in (16, 20, 100, 128):
                b, hq, hkv, tq, tk = case[:5]
                q, k = ((rng.integers(-16, 17, sh) / 8.0).astype(np.float32) for sh in
                        ((b, hq, tq, d), (b, hkv, tk, d)))
                v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
                q, k, v = (torch.as_tensor(x, device=cuda).to(dtype) for x in (q, k, v))
                _, _, _, info, kw = _normal_operands(case, d, "cpu", seed=0)
                info = info.to(cuda)
                kw.update(block_k=bk, pv_int8=True)
                before = flash_mod.PV_INT8_LAUNCHES.count
                got = flash_mod.flash_star_attention(q, k, v, info, fmt=fmt, **kw)
                assert flash_mod.PV_INT8_LAUNCHES.count == before + 1
                ref = flash_mod.flash_star_ref(q, k, v, info, fmt=fmt, **kw)
                torch.testing.assert_close(got.float(), ref.float(), **tol)
