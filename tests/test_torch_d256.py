"""The last of the kernels' domain: flash_star's float32 kernel and its int8
P.V variant at head_dim 256, the int8 P.V variant over KV blocks of any
size, and the paged decode kernel at head_dim 256, against the JAX
reference and (marked ``cuda``) on the card.

With no card the wrappers run their plain versions, which take any D and
any block already; here they are held to the JAX kernels in interpret mode
on the same inputs:

* the int8 P.V variant at D 256 and at ``block_k`` 192 / 256 (several
  blocks, a ragged last one): the int32 grid indices and each block's
  running grid max (STAR) bit-exact, V's codes and scales bit-exact
  (``ref.quantize_v_blocks`` against the TPU kernel's expressions), outputs
  at ``atol=1e-6`` (float32 sums in another order; dyadic q and k make
  every score exact, so no grid level or code differs);
* the paged decode at D 256 over float32 and bf16 pages and int8 / fp8
  codes, recurrentgemma-2b's group of 10 q heads over one KV head, at
  ``atol=1e-5`` (bf16 outputs: and one bf16 ulp, ``rtol=2^-8``);
* the slice as a whole: recurrentgemma's smoke config at ``head_dim=256``,
  float32, with a window of 16 under 21-token prompts (the ring wraps), on
  the lockstep engine: greedy tokens equal to the JAX ``ServeEngine``'s
  over 8 steps.

The ``cuda`` tests hold each new kernel instantiation to its plain version
on the card (the tf32 kernel at D 256, the int8 P.V variant at D 16 / 128
/ 256 over blocks of 16 to 600 rows, its V pre-pass bit for bit, the paged
kernel at D 256 over every page type at G 1 / 10 / 16), check that the new
instantiations spill nothing, and hold the D-256 smoke path's tokens on the
card to the CPU's; they skip where there is no card.
"""

import dataclasses
import importlib
import re

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import get_smoke_config
from repro_torch.core import kvquant
from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.core.fixedpoint import quantize_logits
from repro_torch.kernels import _cuda
from repro_torch.models.param import from_reference, materialize, tree_map
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeConfig, ServeEngine

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
    from repro.kernels.paged_attention.kernel import paged_flash_attention as jax_paged
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro.serve.engine import ServeEngine as JaxServeEngine
except ImportError:
    jax = None

flash_mod = importlib.import_module("repro_torch.kernels.flash_star.kernel")
ref_mod = importlib.import_module("repro_torch.kernels.flash_star.ref")
paged_mod = importlib.import_module("repro_torch.kernels.paged_attention.kernel")
split_tests = importlib.import_module("test_torch_paged_split")  # exact paged operands

D256 = 256
PV_ATOL = 1e-6  # int8 P.V: equal codes, float32 sums in another order
PAGED_ATOL = 1e-5  # paged decode: float32 sums in another order
GRID_SENTINEL = -(1 << 24)


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


def _tol(dtype):
    # bf16 outputs: both round one float32 value after sums in another order
    if dtype == torch.bfloat16:
        return dict(atol=8e-3, rtol=8e-3)
    return dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the int8 P.V variant at D 256 and past 128-row blocks

PV_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid, d, block_k
    (1, 10, 1, 24, 600, True, None, 576, None, D256, 256),    # D 256, G 10, a ragged last block
    (2, 4, 2, 9, 450, True, None, 441, (450, 300), 64, 192),  # ragged batch, blocks of 192
    (1, 4, 1, 40, 520, True, 200, 480, None, 32, 256),        # a window across two blocks
    (2, 4, 2, 16, 300, False, None, 0, (300, 131), D256, 192),  # not causal, D 256
]


def _pv_operands(case, seed):
    b, hq, hkv, tq, tk, causal, window, q_off, kvl, d, bk = case
    rng = np.random.default_rng(seed)
    q, k = _dyadic(rng, (b, hq, tq, d)), _dyadic(rng, (b, hkv, tk, d))
    v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    if kvl is not None:  # the rows past kv_valid hold V's largest values: they count in vamax
        for i, n in enumerate(kvl):
            v[i, :, n:] *= 4.0
    info = np.array([q_off] + list(kvl or [tk] * b), np.int32)
    return q, k, v, info, dict(causal=causal, sliding_window=window, block_k=bk)


@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", PV_CASES)
def test_pv_int8_plain_matches_pallas_at_d256_and_long_blocks(case, star, jax_ref):
    q, k, v, info, kw = _pv_operands(case, seed=61)
    want = np.asarray(jax_flash(
        *map(jnp.asarray, (q, k, v, info)), fmt=JFMT if star else None, block_q=8,
        pv_int8=True, interpret=True, **kw))
    got = flash_mod.flash_star_attention(
        *map(torch.as_tensor, (q, k, v, info)), fmt=FMT if star else None, pv_int8=True, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=PV_ATOL, rtol=0)


def _jax_grid_maxes(q, k, info, causal, window, bk):
    """The TPU kernel's int32 grid indices (kernel.py:107-115) and each row's
    running grid max after every block of ``bk`` columns, in jnp."""
    b, hq, tq, d = q.shape
    g = hq // k.shape[1]
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, 1),
                   preferred_element_type=jnp.float32) * (d ** -0.5)
    rows = info[0] + np.arange(tq)[:, None]
    cols = np.arange(k.shape[2])[None, :]
    mask = (cols < info[1:, None, None, None]) & np.ones((1, 1, tq, 1), bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    jg = jnp.where(mask, jnp.round(s * jnp.float32(JFMT.scale)).astype(jnp.int32), GRID_SENTINEL)
    nb = -(-k.shape[2] // bk)
    pad = jnp.pad(jg, ((0, 0), (0, 0), (0, 0), (0, nb * bk - k.shape[2])),
                  constant_values=GRID_SENTINEL)
    blocks = pad.reshape(b, hq, tq, nb, bk).max(-1)
    return np.asarray(jg), np.asarray(jax.lax.cummax(blocks, axis=3))


def _torch_grid_maxes(q, k, info, causal, window, bk):
    """The same from the port's numerics: the plain version's einsum and
    ``quantize_logits``, masked as ``blocked_attention`` masks."""
    b, hq, tq, d = q.shape
    g = hq // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(g, 1)) * d ** -0.5
    rows = int(info[0]) + torch.arange(tq)[:, None]
    cols = torch.arange(k.shape[2])[None, :]
    mask = (cols < info[1:, None, None, None]) & torch.ones((1, 1, tq, 1), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    jg = torch.where(mask, quantize_logits(s, FMT), torch.full_like(s, GRID_SENTINEL,
                                                                   dtype=torch.int32))
    nb = -(-k.shape[2] // bk)
    pad = torch.nn.functional.pad(jg, (0, nb * bk - k.shape[2]), value=GRID_SENTINEL)
    blocks = pad.reshape(b, hq, tq, nb, bk).amax(-1)
    return jg.numpy(), torch.cummax(blocks, dim=3).values.numpy()


@pytest.mark.parametrize("case", PV_CASES)
def test_grid_and_block_running_max_are_the_pallas_kernels_bit_for_bit(case, jax_ref):
    q, k, v, info, kw = _pv_operands(case, seed=62)
    want = _jax_grid_maxes(q, k, info, kw["causal"], kw["sliding_window"], kw["block_k"])
    got = _torch_grid_maxes(*map(torch.as_tensor, (q, k, info)), kw["causal"],
                            kw["sliding_window"], kw["block_k"])
    for a, b_ in zip(got, want):
        assert a.dtype == b_.dtype == np.int32
        np.testing.assert_array_equal(a, b_)


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


@pytest.mark.parametrize("tk,bk", [(600, 256), (450, 192), (256, 256), (300, 1000)])
def test_v_codes_at_d256_and_long_blocks_equal_the_jax_kernel(tk, bk, jax_ref):
    rng = np.random.default_rng(63)
    v = rng.normal(size=(2, 1, tk, D256)).astype(np.float32)
    v[1, 0, -1] *= 8.0  # the last (ragged) block's absmax in its last row
    bk = min(bk, tk)
    got_codes, got_scales = ref_mod.quantize_v_blocks(torch.as_tensor(v), bk)
    want_codes, want_scales = _jax_codes(v, bk)
    np.testing.assert_array_equal(got_codes.numpy(), want_codes)
    np.testing.assert_array_equal(got_scales.numpy().view(np.int32), want_scales.view(np.int32))
    lay = ref_mod.v8_layout(got_codes, bk)
    assert tuple(lay.shape) == flash_mod.v8_shape(2, 1, tk, D256, bk)[0]


# ---------------------------------------------------------------------------
# the paged decode at D 256

PAGED_CASES = [
    # s, w, bs, hq, hkv, lens  (a 0 is a free slot)
    (3, 8, 16, 10, 1, (100, 0, 77)),   # recurrentgemma's group of 10
    (2, 6, 32, 10, 1, (190, 65)),      # pages of 32, rows past one split
]


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_pallas_at_d256(case, star, pool, jax_ref):
    """float32 and bf16 pages (q of the pool's type) and int8 / fp8 codes
    with per-(block, head) power-of-two scales, float32 q; dyadic q and
    page values, so every score is exact and no grid level differs."""
    s, w, bs, hq, hkv, lens = case
    fp = pool in ("fp32", "bf16")
    q, kp, vp, scales, tables, kvl = ops_ = split_tests._operands(
        np.random.default_rng(64), "fp32" if fp else pool, s, w, bs, hq, hkv, D256, lens)
    (qt, kt, vt, tt, lt), kw_t = split_tests._torch_args(ops_, "fp32" if fp else pool)
    qj, kj, vj = jnp.asarray(q), *(split_tests._jax_pool(x, "fp32" if fp else pool)
                                   for x in (kp, vp))
    if pool == "bf16":  # dyadic values of 5 bits: bf16 holds them exactly
        qt, kt, vt = qt.bfloat16(), kt.bfloat16(), vt.bfloat16()
        qj, kj, vj = (x.astype(jnp.bfloat16) for x in (qj, kj, vj))
    kw_j = {} if scales is None else dict(k_scale=jnp.asarray(scales[0]),
                                          v_scale=jnp.asarray(scales[1]))
    want = np.asarray(jax_paged(qj, kj, vj, jnp.asarray(tables), jnp.asarray(kvl),
                                fmt=JFMT if star else None, interpret=True, **kw_j))
    got = paged_mod.paged_flash_attention(qt, kt, vt, tt, lt, fmt=FMT if star else None, **kw_t)
    assert got.dtype == qt.dtype
    # bf16 outputs: each side rounds a float32 value (sums in another order)
    # to bf16 once, so the two may sit one bf16 ulp (2^-8 relative) apart
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=PAGED_ATOL,
                               rtol=2.0 ** -8 if pool == "bf16" else 0)
    assert not got[lt == 0].any()


# ---------------------------------------------------------------------------
# the slice: recurrentgemma's smoke config at D 256 in float32

HYBRID = "recurrentgemma_2b"


def _d256_configs():
    """The smoke config (float32 compute, window 16) at head_dim 256, in
    both packages, on the kernels' route in the port."""
    cfg_t = dataclasses.replace(get_smoke_config(HYBRID), head_dim=D256, attn_impl="pallas")
    assert cfg_t.compute_dtype == "float32" and cfg_t.local_window == 16
    if jax is None:
        return None, cfg_t
    return dataclasses.replace(jax_smoke_config(HYBRID), head_dim=D256), cfg_t


def test_d256_float32_lockstep_tokens_match_the_jax_serve_engine(jax_ref):
    """21-token prompts under the window of 16 (the prefill masks, the ring
    wraps), 8 greedy steps: the same tokens as the JAX engine's."""
    cfg_j, cfg_t = _d256_configs()
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    prompts = np.random.default_rng(65).integers(0, 256, (2, 21)).astype(np.int32)
    ref, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=40)).generate(
        jnp.asarray(prompts), 8)
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=40), device="cpu")
        got, info_t = eng.generate(prompts, 8)
    assert got.tolist() == np.asarray(ref).tolist()
    assert info_t == info_j


# ---------------------------------------------------------------------------
# on the card

TF32_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 10, 1, 40, 40, True, 16, 0, None),              # a window inside a 32-row q block
    (1, 10, 1, 300, 300, True, 128, 0, None),           # across q blocks and 16-row tiles
    (4, 10, 1, 1, 520, False, None, 0, (520, 300, 64, 1)),  # ring steps, ragged
    (1, 4, 2, 17, 33, True, None, 16, (30,)),           # q_offset, ragged, GQA 4:2
]


@pytest.mark.cuda
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_tf32_kernel_at_d256_matches_plain_on_card(cuda, star):
    """Dyadic q and k (every score exact, in tf32 too), normal v: the
    float32 kernel at D 256 within 1e-5 + 1e-5 |plain| of the plain
    version, one launch a call, heads-major and as transposed views."""
    rng = np.random.default_rng(66)
    for b, hq, hkv, tq, tk, causal, window, q_off, kvl in TF32_CASES:
        for transposed in (False, True):
            shapes = [(b, hq, tq, D256), (b, hkv, tk, D256), (b, hkv, tk, D256)]
            if transposed:
                shapes = [(sh[0], sh[2], sh[1], sh[3]) for sh in shapes]
            q, k = (torch.as_tensor(_dyadic(rng, sh), device=cuda) for sh in shapes[:2])
            v = torch.as_tensor(rng.normal(size=shapes[2]).astype(np.float32), device=cuda)
            if transposed:
                q, k, v = (x.transpose(1, 2) for x in (q, k, v))
            info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32, device=cuda)
            kw = dict(fmt=FMT if star else None, causal=causal, sliding_window=window)
            before = flash_mod.LAUNCHES.count
            got = flash_mod.flash_star_attention(q, k, v, info, **kw)
            assert flash_mod.LAUNCHES.count == before + 1
            ref = flash_mod.flash_star_ref(q, k, v, info, **kw)
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_pv_int8_kernel_at_d256_and_long_blocks_matches_plain_on_card(cuda, dtype, star):
    """Dyadic q and k (equal codes): the int8 P.V variant at D 16, 128 and
    256 over blocks of 16 to 600 rows (one block of all 300 rows, ragged
    last blocks, a window) within float32 rounding of the plain version
    (bf16: two bf16 ulps), one count a call; its pre-pass's codes and
    scales bit for bit."""
    fmt = FMT if star else None
    lib = flash_mod._cuda.load(flash_mod.SOURCE, flash_mod._bind)
    cases = PV_CASES + [(2, 8, 2, 130, 300, True, None, 170, (300, 260), 128, 600),
                        (1, 10, 1, 64, 700, True, 600, 636, None, D256, 16)]
    for i, case in enumerate(cases):
        for d in sorted({case[9], 16, D256}):
            q, k, v, info, kw = _pv_operands(case[:9] + (d, case[10]), seed=67 + i)
            q, k, v = (torch.as_tensor(x, device=cuda).to(dtype) for x in (q, k, v))
            info = torch.as_tensor(info, device=cuda)
            before = flash_mod.PV_INT8_LAUNCHES.count
            got = flash_mod.flash_star_attention(q, k, v, info, fmt=fmt, pv_int8=True, **kw)
            assert flash_mod.PV_INT8_LAUNCHES.count == before + 1
            ref = flash_mod.flash_star_ref(q, k, v, info, fmt=fmt, pv_int8=True, **kw)
            torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
            bk = min(kw["block_k"], k.shape[2])
            codes, scales = flash_mod._quantize_v(lib, v, bk, _cuda.stream_handle(cuda))
            want_codes, want_scales = ref_mod.quantize_v_blocks(v, bk)
            assert torch.equal(codes, ref_mod.v8_layout(want_codes, bk))
            assert torch.equal(scales, want_scales)


PAGED_CARD = [
    # w, bs, lens: rows past 2048 (a 2048-row ring and more), one split, splits inside pages
    (140, 16, (2200, 2048, 0, 1)),
    (3, 16, (40, 17)),
    (8, 48, (300, 47)),
]
PAGED_GROUPS = ((10, 1), (16, 1), (2, 2))  # (hq, hkv): G 10, 16 (MAX_GROUP), 1


@pytest.mark.cuda
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8", "fp8_e4m3"])
def test_paged_kernel_at_d256_matches_plain_on_card(cuda, pool, star):
    """D 256 over float32 / bf16 pages (q of the pool's type) and int8 /
    fp8 codes (float32 and bf16 q), at G 10, 16 and 1, one count a call.
    Dyadic q, pages of dyadic values or codes under power-of-two scales:
    every score exact, so no grid level differs."""
    rng = np.random.default_rng(68)
    fmt = FMT if star else None
    for w, bs, lens in PAGED_CARD:
        for hq, hkv in PAGED_GROUPS:
            ops_ = split_tests._operands(rng, "fp32" if pool == "bf16" else pool, len(lens), w,
                                         bs, hq, hkv, D256, lens)
            (q, kp, vp, tables, kvl), kw = split_tests._torch_args(
                ops_, "fp32" if pool == "bf16" else pool, cuda)
            qtypes = (torch.float32, torch.bfloat16)
            if pool == "bf16":
                kp, vp, qtypes = kp.bfloat16(), vp.bfloat16(), (torch.bfloat16,)
            elif pool == "fp32":
                qtypes = (torch.float32,)
            counter = paged_mod.LAUNCHES if not kw else paged_mod.LAUNCHES_QUANT
            for qtype in qtypes:
                before = counter.count
                got = paged_mod.paged_flash_attention(q.to(qtype), kp, vp, tables, kvl, fmt=fmt,
                                                      **kw)
                assert counter.count == before + 1
                ref = paged_mod.paged_attention_ref(q.to(qtype), kp, vp, tables, kvl, fmt=fmt,
                                                    **kw)
                torch.testing.assert_close(got.float(), ref.float(), **_tol(qtype))
                assert not got[kvl == 0].any()


@pytest.mark.cuda
def test_d256_instantiations_spill_nothing(cuda):
    """ptxas's lines for every D-256 instantiation of flash_star's float32
    kernel (2), int8 P.V kernel (float32 and bf16 q/k: 4) and block route
    (float32 and bf16: 2), the two V pre-pass instantiations, and the paged
    split kernel at D 256 (2 q types x 3 pool types x STAR / exact, and the
    block route's scores and weights modes x the same 6: 24): 0 bytes of
    spill stores and loads."""
    logs = _cuda.build([flash_mod.SOURCE, paged_mod.SOURCE])
    found = {}
    for path, pattern in ((flash_mod.SOURCE, r"flash_star_(tf32|pv_int8|blocked)_kernel.*Li256E|"
                                             r"flash_star_quantize_v_kernel"),
                          (paged_mod.SOURCE, r"paged_split_kernel.*Li256E")):
        cur = None
        for line in logs[path].splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                cur = m.group(1) if re.search(pattern, m.group(1)) else None
            elif cur and "spill" in line:
                found[cur] = line
    assert len(found) == 2 + 4 + 2 + 2 + 24, sorted(found)
    assert all("0 bytes spill stores, 0 bytes spill loads" in x for x in found.values()), found


@pytest.mark.cuda
def test_d256_float32_smoke_lockstep_on_card_equals_cpu(cuda):
    """The slice's smoke path on the card (flash_star's float32 kernel at D
    256, once per attention layer of the prefill and of each replay): the
    CPU's greedy tokens."""
    cfg = dataclasses.replace(get_smoke_config(HYBRID), head_dim=D256, attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    prompts = np.random.default_rng(69).integers(0, 256, (3, 22)).astype(np.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else tree_map(lambda t: t.cuda(), params)
        before = flash_mod.LAUNCHES.count
        eng = ServeEngine(cfg, p, ServeConfig(max_len=40), device=dev)
        outs[dev] = eng.generate(prompts, 10)[0].cpu().tolist()
        if dev == "cuda":
            assert flash_mod.LAUNCHES.count - before == 10
    assert outs["cpu"] == outs["cuda"]
