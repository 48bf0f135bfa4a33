"""The port at the paper's swept softmax formats (9 bits down to 2), and the
slice that sweeps them (``examples/torch_precision_sweep.py``).

Under STAR the online softmax rescales by ``lut[min(shift, top)]``; the
identity ``lut[a] * lut[b] == lut[a + b]`` fails once ``a + b`` passes the
deepest level ``top``, where the table clamps, so at 2 to 5 bits the result
depends on the block schedule.  The TPU kernels walk fixed schedules:
flash_star blocks of ``block_k`` rows from row 0, paged decode one page at a
time.  Here, with no card:

* the paged plain version against the JAX kernel in interpret mode at u2,
  u3, u4, u5, u8 and u9 over fp32, int8 and fp8 pages (bs 8, 16 and 64,
  ragged lens with a free slot and partial pages), beside float32
  emulations of the CUDA kernel's block route (scores, the page scan, the
  weighted split P.V, the combine), which must match, and of its one-pass
  split-KV schedule, which must not at u2 and u3;
* the same for flash_star: an emulation of the block route (each
  ``block_k`` block's max before its P, 32-row sub-tiles) within float32
  rounding of the JAX kernel at ``block_k`` 128, the one-pass 32-row tile
  loop outside it at u2 and u3;
* the port's paged continuous engine at a 3-bit format: greedy tokens equal
  to the JAX engine's;
* the route rule (``core.lut.clamp_is_negligible``) per format, and the
  wrappers' routing through fake libraries (the block route's own entry,
  count and workspace);
* the classifier of the sweep against ``benchmarks/accuracy_bitwidth.py``:
  ``gen_data`` bit-equal, the parameter draws, one Adam step from carried
  parameters, a reference-trained classifier's logits and predictions at
  every format, and the port's own 300-step training meeting the
  reference's assertions.

``cuda``-marked tests hold the block routes to their plain versions on the
card at the 8 swept formats (and pv_int8 and the STAR softmax there), and
skip here.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.core.lut import clamp_is_negligible, exp_lut
from repro_torch.kernels.flash_star import kernel as flash_mod
from repro_torch.kernels.paged_attention import kernel as paged_mod
from repro_torch.kernels.star_softmax import kernel as soft_mod

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sweep = importlib.import_module("torch_precision_sweep")

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax
    import jax.numpy as jnp

    from repro.core.fixedpoint import FixedPointFormat as JFormat
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
    from repro.kernels.paged_attention.kernel import paged_flash_attention as jax_paged
except ImportError:
    jnp = None

split_mod = importlib.import_module("test_torch_paged_split")

GRID_SENTINEL = -(1 << 24)
ATOL = 1e-5
# the formats the CPU comparisons hold: the sweep's low end (the block
# route) and two of the one-pass route's
SWEPT = {"u2": (1, 1), "u3": (2, 1), "u4": (3, 1), "u5": (4, 1), "u8": (6, 2), "u9": (6, 3)}
# the reference's SWEEPS (9 bits down to 2), every one on the card
ALL8 = [(6, 3), (6, 2), (5, 2), (5, 1), (4, 1), (3, 1), (2, 1), (1, 1)]
FAULTY = ("u2", "u3")  # where the one-pass schedules are far from the TPU kernels'


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


def _tol(dtype):
    # bf16 outputs: the kernel and the plain version round the same float32
    # value to bf16 only after summing in different orders (2 bf16 ulps)
    if dtype == torch.bfloat16:
        return dict(atol=8e-3, rtol=8e-3)
    return dict(atol=ATOL, rtol=1e-5)


def _far(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# the route rule


def test_clamp_rule_routes_two_to_five_bits_to_the_block_route():
    for bits in ALL8:
        fmt = FixedPointFormat(*bits)
        negligible = clamp_is_negligible(fmt, 1 << 20)
        assert negligible == (fmt.total_bits >= 6), fmt.short_name()
        assert clamp_is_negligible(fmt, 32) == negligible
    # the rule is the bound itself: rows * lut[top] against 2^-24
    u6 = FixedPointFormat(5, 1)
    top = float(exp_lut(u6)[-1])
    assert clamp_is_negligible(u6, int(2.0 ** -24 / top) - 1)
    assert not clamp_is_negligible(u6, int(2.0 ** -24 / top) + 1)


# ---------------------------------------------------------------------------
# paged decode: the plain version and the two schedules against the JAX kernel


def _snap(x, scale):
    v = np.rint(x * np.float32(scale))
    return np.clip(v, GRID_SENTINEL, -GRID_SENTINEL).astype(np.int64)


def emulate_paged_block_route(q, kd, vd, kv_valid, fmt, bs, rows=paged_mod.SPLIT_ROWS):
    """The CUDA block route in float32 over the gathered (dequantized) rows
    ``kd``/``vd`` [S, W*bs, Hkv, D]: the grid index of every live row, page
    maxima ``b_p``, ``M_p = max(b_0 .. b_p)``, ``R_p`` the product of the
    later pages' ``lut[min(M_p' - M_p'-1, top)]``, each row weighted
    ``lut[min(M_p - j, top)] * R_p``, P.V and the weights' sum per split of
    ``rows`` rows, the live splits added in order (the combine at r = 1),
    the sum divided (``l <= 0`` -> 1)."""
    s_, hq, d = q.shape
    w_rows, hkv = kd.shape[1], kd.shape[2]
    g = hq // hkv
    lut = exp_lut(fmt).numpy()
    top = lut.shape[0] - 1
    out = np.zeros((s_, hq, d), np.float32)
    sm = np.float32(d ** -0.5)
    for s in range(s_):
        kv = min(max(int(kv_valid[s]), 0), w_rows)
        np_ = -(-kv // bs)
        for hk in range(hkv):
            qg = q[s, hk * g:(hk + 1) * g]
            sc = (qg @ kd[s, :kv, hk].T).astype(np.float32) * sm
            j = _snap(sc, fmt.scale)  # [G, kv]
            b = np.stack([j[:, p * bs:min((p + 1) * bs, kv)].max(axis=1) for p in range(np_)],
                         axis=1) if np_ else np.zeros((g, 0), np.int64)
            m = np.maximum.accumulate(b, axis=1) if np_ else b
            r_next = np.ones((g, np_), np.float32)
            r_next[:, :-1] = lut[np.minimum(m[:, 1:] - m[:, :-1], top)]
            big_r = np.ones((g, np_), np.float32)
            for p in range(np_ - 2, -1, -1):
                big_r[:, p] = (r_next[:, p] * big_r[:, p + 1]).astype(np.float32)
            page = np.arange(kv) // bs
            wgt = (lut[np.minimum(m[:, page] - j, top)] * big_r[:, page]).astype(np.float32)
            l = np.zeros(g, np.float32)
            acc = np.zeros((g, d), np.float32)
            for lo in range(0, kv, rows):
                hi = min(lo + rows, kv)
                l = (l + wgt[:, lo:hi].sum(axis=1, dtype=np.float32)).astype(np.float32)
                acc = (acc + wgt[:, lo:hi] @ vd[s, lo:hi, hk]).astype(np.float32)
            out[s, hk * g:(hk + 1) * g] = acc / np.where(l <= 0, 1.0, l)[:, None]
    return out


def _gathered(ops, pool):
    q, kp, vp, scales, tables, kvl = ops
    from repro_torch.core import kvquant
    from repro_torch.kernels.paged_attention.ref import gather_pages

    if scales is not None:
        kp, vp = (kvquant.decode(split_mod._torch_pool(a, pool), torch.as_tensor(sc)[:, None, :, None])
                  for a, sc in ((kp, scales[0]), (vp, scales[1])))
    else:
        kp, vp = torch.as_tensor(kp), torch.as_tensor(vp)
    kd, vd = gather_pages(kp, vp, torch.as_tensor(tables))
    return kd.float().numpy(), vd.float().numpy()


# u2 and u3 over every pool, each of the others over one: every bs and pool
PAGED_RUNS = [
    pytest.param(name, pool, bs, id=f"{name}-{pool}-bs{bs}")
    for name, pool, bs in [
        ("u2", "fp32", 8), ("u2", "int8", 16), ("u2", "fp8_e4m3", 64),
        ("u3", "fp32", 16), ("u3", "int8", 64), ("u3", "fp8_e4m3", 8),
        ("u4", "fp8_e4m3", 16), ("u5", "int8", 8), ("u8", "fp32", 64), ("u9", "fp8_e4m3", 16),
    ]
]


@pytest.mark.parametrize("name, pool, bs", PAGED_RUNS)
def test_paged_plain_and_block_route_match_pallas(name, pool, bs, jax_ref):
    """The plain version (any route's CPU result) and the block route's
    emulation within 1e-5 of the JAX kernel; at u2 and u3 the one-pass
    split-KV schedule's emulation is not where pages are shorter than its
    64-row splits (dyadic q and K: every score is exact, so no grid level
    differs between the four)."""
    lens = (0, 37, 129, 200)
    w = -(-200 // bs) + 1
    ops = split_mod._operands(np.random.default_rng(61), pool, 4, w, bs, 4, 2, 16, lens)
    if pool != "fp32":  # codes times their scales are small: spread the scores
        ops = (ops[0] * 4,) + ops[1:]
    q, kp, vp, scales, tables, kvl = ops
    fmt = FixedPointFormat(*SWEPT[name])
    kw = {} if scales is None else dict(k_scale=jnp.asarray(scales[0]),
                                        v_scale=jnp.asarray(scales[1]))
    want = np.asarray(jax_paged(
        jnp.asarray(q), split_mod._jax_pool(kp, pool), split_mod._jax_pool(vp, pool),
        jnp.asarray(tables), jnp.asarray(kvl), fmt=JFormat(*SWEPT[name]), interpret=True, **kw))
    args, tkw = split_mod._torch_args(ops, pool)
    got = paged_mod.paged_flash_attention(*args, fmt=fmt, **tkw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert not got[0].any()  # the free slot emits zeros
    kd, vd = _gathered(ops, pool)
    block = emulate_paged_block_route(q, kd, vd, kvl, fmt, bs)
    np.testing.assert_allclose(block, want, atol=ATOL, rtol=0)
    one_pass, _ = split_mod.emulate_split_kv(q, kd, vd, kvl, fmt, 16 ** -0.5,
                                             paged_mod.SPLIT_ROWS)
    if name in FAULTY and bs < paged_mod.SPLIT_ROWS:
        assert _far(one_pass, want) > 1e-3, (name, _far(one_pass, want))
    elif name in ("u8", "u9"):
        np.testing.assert_allclose(one_pass, want, atol=ATOL, rtol=0)


def test_paged_block_route_is_batch_invariant_in_emulation():
    """A slot's weights depend on its own pages only: alone, in a batch and
    under a wider table, the same bits."""
    fmt = FixedPointFormat(2, 1)
    alone, batch = split_mod._slot_views(np.random.default_rng(62), "fp32", 16,
                                         split_mod.INVARIANCE_LENS, 70, 2)
    outs = []
    for ops in (alone, batch):
        kd, vd = _gathered(ops, "fp32")
        outs.append(emulate_paged_block_route(ops[0], kd, vd, ops[5], fmt, 16))
    assert np.array_equal(outs[0][0], outs[1][2])


# ---------------------------------------------------------------------------
# flash_star: the block route and the one-pass tile loop against the JAX kernel


def emulate_flash(q, k, v, info, fmt, causal, window, *, block, sub=32):
    """flash_star in float32.  ``block`` rows a KV block from row 0, each
    walked twice: its max (over the live entries) moves the running max
    once, the running state is rescaled once, then p = lut[min(m - j, top)]
    and P.V over sub-tiles of ``sub`` rows; l = l r + the block's sum of p.
    ``block == sub`` is the one-pass kernels' tile loop."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    kf, vf = (x.repeat_interleave(hq // hkv, 1) for x in (k, v))
    rows = int(info[0]) + torch.arange(tq)[:, None]
    valid = info[1:].long()[:, None, None, None]
    lut, top = exp_lut(fmt), fmt.num_levels - 1
    m = torch.full((b, hq, tq), GRID_SENTINEL, dtype=torch.int64)
    l, o = torch.zeros(b, hq, tq), torch.zeros(b, hq, tq, d)
    sm = np.float32(d ** -0.5)
    for c0 in range(0, tk, block):
        cols = c0 + torch.arange(min(block, tk - c0))[None, :]
        live = (cols < valid) & ((cols <= rows) if causal else True)
        if window is not None:
            live = live & (cols > rows - window)
        live = live.expand(b, hq, tq, cols.shape[1])
        s = (q @ kf[:, :, c0:c0 + block].transpose(-1, -2)) * sm
        jg = torch.where(live, torch.round(s * fmt.scale).long(), torch.tensor(GRID_SENTINEL))
        m_new = torch.maximum(m, jg.amax(-1))
        r = lut[(m_new - m).clamp(max=top)]
        p = torch.where(live, lut[(m_new[..., None] - jg).clamp(0, top)], 0.0)
        o = o * r[..., None]
        for u in range(0, cols.shape[1], sub):
            o = o + p[..., u:u + sub] @ vf[:, :, c0 + u:c0 + min(u + sub, cols.shape[1])]
        l = l * r + p.sum(-1)
        m = m_new
    return o / torch.where(l <= 0, 1.0, l)[..., None]


FLASH_EMU_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 4, 2, 300, 300, True, None, 0, None),          # 3 blocks, the last of 44 rows
    (2, 4, 2, 20, 270, False, None, 0, (270, 150)),     # ragged, non-causal
]


@pytest.mark.parametrize("case, name", [
    pytest.param(case, name, id=f"{cid}-{name}")
    for case, cid in zip(FLASH_EMU_CASES, ("causal", "ragged"))
    for name in (SWEPT if cid == "causal" else FAULTY)])
def test_flash_block_route_emulation_matches_pallas(case, name, jax_ref):
    """Dyadic q and k (every score exact), normal v, block_k 128: the block
    route's emulation and the plain version within 1e-5 of the JAX kernel;
    at u2 and u3 the one-pass 32-row tile loop is not."""
    b, hq, hkv, tq, tk, causal, window, q_off, kvl = case
    rng = np.random.default_rng(63)
    d = 16
    q = (rng.integers(-16, 17, (b, hq, tq, d)) / 8.0).astype(np.float32)
    k = (rng.integers(-16, 17, (b, hkv, tk, d)) / 8.0).astype(np.float32)
    v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    info = np.array([q_off] + list(kvl or [tk] * b), np.int32)
    want = np.asarray(jax_flash(
        *map(jnp.asarray, (q, k, v, info)), fmt=JFormat(*SWEPT[name]), causal=causal,
        sliding_window=window, block_q=128, block_k=128, interpret=True))
    fmt = FixedPointFormat(*SWEPT[name])
    args = tuple(map(torch.as_tensor, (q, k, v, info)))
    block = emulate_flash(*args, fmt, causal, window, block=128)
    np.testing.assert_allclose(block.numpy(), want, atol=ATOL, rtol=0)
    plain = flash_mod.flash_star_attention(*args, fmt=fmt, causal=causal, sliding_window=window)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=0)
    tiles = emulate_flash(*args, fmt, causal, window, block=32)
    if name in FAULTY:
        assert _far(tiles, want) > 1e-3, (name, _far(tiles, want))
    elif name in ("u8", "u9"):
        np.testing.assert_allclose(tiles.numpy(), want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the wrappers' routing, through fake libraries


class _RouteLib:
    """Every C entry of both sources; records each call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _fake(monkeypatch, mod, lib):
    monkeypatch.setattr(mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(mod._cuda, "stream_handle", lambda device: 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", ALL8, ids=lambda f: f"{f[0]}i.{f[1]}f")
def test_flash_wrapper_routes_by_format(bits, dtype, monkeypatch):
    lib = _RouteLib()
    _fake(monkeypatch, flash_mod, lib)
    q = torch.zeros(1, 4, 40, 16, dtype=dtype)
    k = v = torch.zeros(1, 2, 300, 16, dtype=dtype)
    info = torch.tensor([0, 300], dtype=torch.int32)
    fmt = FixedPointFormat(*bits)
    before = (flash_mod.LAUNCHES.count, flash_mod.BLOCKED_LAUNCHES.count)
    flash_mod.flash_star_attention(q, k, v, info, fmt=fmt, block_k=200)
    blocked = fmt.total_bits <= 5
    one_pass = "flash_star_mma_launch" if dtype == torch.bfloat16 else "flash_star_tf32_launch"
    assert [c[0] for c in lib.calls] == ["flash_star_blocked_launch" if blocked else one_pass]
    after = (flash_mod.LAUNCHES.count, flash_mod.BLOCKED_LAUNCHES.count)
    assert after == ((before[0], before[1] + 1) if blocked else (before[0] + 1, before[1]))
    args = lib.calls[0][1]
    if blocked:  # dtype, the softmax's five, then bk = min(block_k, Tk) and the stream
        assert args[24] == (0 if dtype == torch.float32 else 1)
        assert args[25:30] == (1, 0, pytest.approx(0.25), fmt.scale, fmt.num_levels)
        assert args[30:] == (200, 0)
    # the exact softmax keeps the one-pass kernel at any size
    lib.calls.clear()
    flash_mod.flash_star_attention(q, k, v, info, fmt=None)
    assert [c[0] for c in lib.calls] == [one_pass]


@pytest.mark.parametrize("pool", split_mod.POOLS)
@pytest.mark.parametrize("bits", [(2, 1), (6, 2)], ids=["u3", "u8"])
def test_paged_wrapper_routes_by_format(bits, pool, monkeypatch):
    lib = _RouteLib()
    _fake(monkeypatch, paged_mod, lib)
    monkeypatch.setattr(torch.Tensor, "item", split_mod._no_host_read)
    s, w, bs, hq, hkv, d = 3, 40, 16, 8, 2, 16
    ops = split_mod._operands(np.random.default_rng(64), pool, s, w, bs, hq, hkv, d,
                              (130, 600, 0))
    (q, kp, vp, tables, kvl), kw = split_mod._torch_args(ops, pool)
    fmt = FixedPointFormat(*bits)
    before = paged_mod.BLOCKED_LAUNCHES.count
    paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=fmt, **kw)
    entry, args = lib.calls[0]
    assert len(lib.calls) == 1
    splits = paged_mod.num_splits(w, bs)
    if bits == (6, 2):
        assert entry != "paged_attention_blocked_launch"
        assert paged_mod.BLOCKED_LAUNCHES.count == before
        return
    assert entry == "paged_attention_blocked_launch"
    assert paged_mod.BLOCKED_LAUNCHES.count == before + 1
    code = -1 if pool == "fp32" else paged_mod.CODE_DTYPES[kp.dtype]
    assert args[9:17] == (s, hq, hkv, w, bs, d, 0, code)
    assert (args[7] is None) == (pool == "fp32")
    assert args[-1] == splits and args[-2] is not None
    assert paged_mod.blocked_workspace(s, hq, w, bs, d) == \
        s * hq * (splits * (d + 2 + paged_mod.SPLIT_ROWS) + 2 * w)


def test_block_route_entries_are_in_the_sources():
    fsrc, psrc = flash_mod.SOURCE.read_text(), paged_mod.SOURCE.read_text()
    assert 'extern "C" int flash_star_blocked_launch(' in fsrc
    assert "tc_attention<T, D, true, false, true>" in fsrc
    assert 'extern "C" int paged_attention_blocked_launch(' in psrc
    assert "paged_split_kernel<T, C, D, true, 1>" in psrc
    assert "paged_split_kernel<T, C, D, true, 2>" in psrc


# ---------------------------------------------------------------------------
# the continuous engine at a 3-bit format


def test_paged_engine_greedy_tokens_at_3_bits_match_reference(jax_ref):
    import dataclasses

    from repro import ops as jops
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
    from repro.serve.engine import ContinuousConfig as JaxConfig
    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.param import from_reference
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    low = dict(attn_impl="pallas", softmax_int_bits=2, softmax_frac_bits=1)
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), **low)
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), **low)
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    rng = np.random.default_rng(65)
    prompts = [rng.integers(0, cfg_t.vocab_size, (n,)).astype(np.int32) for n in (19, 10)]
    gens = [4, 5]
    kw = dict(num_slots=2, max_len=48, kv_layout="paged", kv_block_size=4)
    with jops.use(softmax="pallas"):
        want = JaxEngine(cfg_j, params_j, JaxConfig(**kw)).serve(prompts, gens)
    with ops.use(softmax="pallas"):
        got = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(**kw),
                                       device="cpu").serve(prompts, gens)
    assert got == want


# ---------------------------------------------------------------------------
# the sweep's classifier against benchmarks/accuracy_bitwidth.py


@pytest.fixture(scope="module")
def ab():
    if jnp is None:
        pytest.skip("needs JAX (the reference)")
    sys.path.insert(0, str(ROOT))
    return importlib.import_module("benchmarks.accuracy_bitwidth")


def _ref_spec(ab_mod, fmt):
    from repro import ops as jops

    return (jops.SoftmaxSpec(kind="exact") if fmt is None
            else jops.SoftmaxSpec(kind="star", precision=ab_mod.FixedPointFormat(*fmt)))


def _port_fmt(fmt):
    return None if fmt is None else FixedPointFormat(*fmt)


def test_classifier_constants_and_data_are_the_references(ab):
    assert (sweep.D, sweep.H, sweep.LAYERS, sweep.VOCAB, sweep.CLASSES, sweep.SEQ) == \
        (ab.D, ab.H, ab.LAYERS, ab.VOCAB, ab.CLASSES, ab.SEQ)
    assert [(f.int_bits, f.frac_bits) for _, f in sweep.FORMATS[1:]] == \
        [(f.int_bits, f.frac_bits) for _, f in ab.SWEEPS]
    for n, seed in ((128, 1000), (1024, 9), (7, 1299)):
        toks, cls = sweep.gen_data(n, seed)
        rt, rc = ab.gen_data(n, seed)
        assert np.array_equal(toks.numpy(), np.asarray(rt))
        assert np.array_equal(cls.numpy(), np.asarray(rc))


@pytest.fixture(scope="module")
def carried(ab):
    ref = ab.init_params(jax.random.PRNGKey(0))
    return ref, sweep.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref))


def test_parameter_draws_are_the_references(carried):
    # hwmodel.prng's normal draws: a few float32 ulps from XLA's log1p
    sweep._map(lambda b, a: torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7),
               sweep.init_params(0), carried[1])


def test_one_adam_step_matches_reference(ab, carried):
    """The reference's first training step (``train(steps=1)``) from the
    same parameters: the port's ``adam_step`` with torch autograd."""
    ref_p, p = carried
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, ab.train(steps=1)))
    zeros = sweep._map(torch.zeros_like, p)
    toks, cls = sweep.gen_data(128, 1000)
    got, mom, _, _ = sweep.adam_step(p, zeros, zeros, toks, cls, 1)
    for a, b, m in zip(want, sweep._leaves(got), sweep._leaves(mom)):
        # at step 1 the update is lr * g / (|g| + 1e-8): a gradient far below
        # float32 rounding of the loss may take either sign in either run
        sure = (m.abs() > 1e-7).numpy()
        np.testing.assert_allclose(b.numpy()[sure], a[sure], atol=1e-6, rtol=0)
        assert np.abs(b.numpy() - a).max() <= 2 * 2e-3 + 1e-6


@pytest.fixture(scope="module")
def trained(ab):
    ref_p = ab.train(steps=12)
    return ref_p, sweep.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_p))


@pytest.mark.parametrize("fmt", [None] + ALL8,
                         ids=lambda f: "exact" if f is None else f"{f[0]}i.{f[1]}f")
def test_reference_trained_classifier_matches_in_the_port(fmt, ab, trained):
    """A classifier trained by the reference (12 steps), carried across: the
    reference's forward (``impl="reference"``) against the port's through
    ``ops.attention(impl="pallas")`` (the plain flash_star here, one 32-row
    block), the same tokens: logits to float32 rounding, the same
    predictions."""
    ref_p, p = trained
    toks, _ = sweep.gen_data(256, 9)
    want = np.asarray(ab.forward(ref_p, jnp.asarray(toks.numpy()), _ref_spec(ab, fmt)))
    with torch.no_grad():
        got = sweep.forward(p, toks, sweep.spec_of(_port_fmt(fmt)), impl="pallas").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_port_training_meets_the_references_assertions():
    """The port's own 300 steps, evaluated through the kernel route:
    ``accuracy_bitwidth.main``'s assertions (exact > 90 %; 7-9 bits within 2
    points of exact; 2 bits more than 2 points under)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # small products: more threads only contend
    try:
        p, _ = sweep.train(steps=300)
    finally:
        torch.set_num_threads(threads)
    rows = {name: acc for name, _, acc, _ in sweep.sweep(p)}
    assert rows["exact"] > 0.9, rows
    for name in ("7b (5i.2f)", "8b (6i.2f)", "9b (6i.3f)"):
        assert rows[name] >= rows["exact"] - 0.02, rows
    assert rows["2b (1i.1f)"] < rows["exact"] - 0.02, rows


# ---------------------------------------------------------------------------
# the reference's last public members, in the port


@pytest.mark.parametrize("over", [{}, dict(softmax_int_bits=2, softmax_frac_bits=1),
                                  dict(softmax_kind="exact", softmax_int_bits=4)],
                         ids=["default", "u3", "exact"])
def test_config_softmax_format_and_config_match_reference(over, jax_ref):
    import dataclasses

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro_torch.configs import get_smoke_config

    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), **over)
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), **over)
    fj, ft = cfg_j.softmax_format, cfg_t.softmax_format
    assert (ft.int_bits, ft.frac_bits) == (fj.int_bits, fj.frac_bits)
    sj, st = cfg_j.softmax_config, cfg_t.softmax_config
    assert (st.kind, st.mode, st.fault) == (sj.kind, sj.mode, sj.fault)
    assert (st.fmt.int_bits, st.fmt.frac_bits) == (sj.fmt.int_bits, sj.fmt.frac_bits)


def test_continuous_config_as_serve_config_matches_reference(jax_ref):
    from repro.serve.engine import ContinuousConfig as JaxConfig
    from repro_torch.serve.engine import ContinuousConfig

    for kw in ({}, dict(max_len=96, temperature=0.7, star_sampling=False)):
        want, got = JaxConfig(**kw).as_serve_config(), ContinuousConfig(**kw).as_serve_config()
        assert (got.max_len, got.temperature, got.star_sampling) == \
            (want.max_len, want.temperature, want.star_sampling)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_block_pool_has_scale_page_matches_reference(kv_dtype, jax_ref):
    from repro.serve.paged import BlockPool as JaxPool
    from repro_torch.serve.paged import BlockPool

    pools = [JaxPool(9, 4, kv_dtype=kv_dtype), BlockPool(9, 4, kv_dtype=kv_dtype)]
    for pool in pools:
        pool.allocate(1, 3)
        pool.allocate(2, 2)
        pool.append(1)
        pool.release(2)
    want, got = ([pool.has_scale_page(b) for b in range(9)] for pool in pools)
    assert got == want and any(got) == (kv_dtype != "fp32")


def test_slot_scheduler_free_slots_matches_reference(jax_ref):
    from repro.serve.scheduler import SlotScheduler as JaxScheduler
    from repro_torch.serve.scheduler import SlotScheduler

    scheds = [JaxScheduler(3), SlotScheduler(3)]
    for sch in scheds:
        assert [s.index for s in sch.free_slots()] == [0, 1, 2]
        for n in (4, 5):
            sch.submit(np.arange(n), 2)
        sch.admit()
        sch.retire(sch.slots[0])
    want, got = ([s.index for s in sch.free_slots()] for sch in scheds)
    assert got == want == [0, 2]


@pytest.mark.parametrize("bits", [(2, 1), (6, 2), None], ids=["u3", "u8", "exact"])
def test_flash_star_blocked_ref_matches_reference(bits, jax_ref):
    from repro.kernels.flash_star.ref import flash_star_blocked_ref as jax_blocked
    from repro_torch.kernels.flash_star.ref import flash_star_blocked_ref

    rng = np.random.default_rng(71)
    q = (rng.integers(-16, 17, (2, 70, 4, 16)) / 8.0).astype(np.float32)
    k = (rng.integers(-16, 17, (2, 70, 2, 16)) / 8.0).astype(np.float32)
    v = rng.normal(size=(2, 70, 2, 16)).astype(np.float32)
    kw = dict(causal=True, q_offset=0, kv_valid_len=np.array([70, 41], np.int32),
              block_size=16)
    want = np.asarray(jax_blocked(*map(jnp.asarray, (q, k, v)),
                                  fmt=None if bits is None else JFormat(*bits), **kw))
    got = flash_star_blocked_ref(*map(torch.as_tensor, (q, k, v)),
                                 fmt=None if bits is None else FixedPointFormat(*bits),
                                 **{**kw, "kv_valid_len": torch.as_tensor(kw["kv_valid_len"])})
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# on the card: the block routes against their plain versions at every format


CARD_FLASH = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid, block_k
    (1, 4, 2, 300, 300, True, None, 0, None, 128),
    (2, 8, 2, 40, 330, True, None, 290, (330, 200), 128),   # q_offset, ragged
    (2, 4, 4, 37, 200, False, None, 0, (200, 61), 64),
    (1, 4, 2, 260, 260, True, 70, 0, None, 100),            # window, blocks of 100
    (4, 8, 2, 1, 544, False, None, 0, (515, 387, 259, 131), 128),  # Tq = 1 decode
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_block_route_matches_plain_on_card(cuda, dtype):
    rng = np.random.default_rng(66)
    for bits in ALL8:
        fmt = FixedPointFormat(*bits)
        for b, hq, hkv, tq, tk, causal, window, q_off, kvl, bk in CARD_FLASH:
            for d in (16, 64, 128, 256):
                q, k = ((rng.integers(-16, 17, sh) / 8.0).astype(np.float32)
                        for sh in ((b, hq, tq, d), (b, hkv, tk, d)))
                v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
                q, k, v = (torch.as_tensor(x, device=cuda).to(dtype) for x in (q, k, v))
                info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32,
                                    device=cuda)
                kw = dict(fmt=fmt, causal=causal, sliding_window=window, block_k=bk)
                before = flash_mod.BLOCKED_LAUNCHES.count
                got = flash_mod.flash_star_attention(q, k, v, info, **kw)
                assert flash_mod.BLOCKED_LAUNCHES.count == before + (fmt.total_bits <= 5)
                ref = flash_mod.flash_star_ref(q, k, v, info, **kw)
                torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype),
                                           msg=lambda m: f"{bits} d={d} {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pv_int8_matches_plain_at_swept_formats_on_card(cuda, dtype):
    """The int8 P.V variant walks block_k blocks already: held at every
    swept format (dyadic q and k: equal codes)."""
    tol = dict(atol=8e-3, rtol=8e-3) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-5)
    rng = np.random.default_rng(67)
    for bits in ALL8:
        for b, hq, hkv, tq, tk, causal, window, q_off, kvl, bk in CARD_FLASH[:3]:
            q, k = ((rng.integers(-16, 17, sh) / 8.0).astype(np.float32)
                    for sh in ((b, hq, tq, 64), (b, hkv, tk, 64)))
            v = rng.normal(size=(b, hkv, tk, 64)).astype(np.float32)
            q, k, v = (torch.as_tensor(x, device=cuda).to(dtype) for x in (q, k, v))
            info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32, device=cuda)
            kw = dict(fmt=FixedPointFormat(*bits), causal=causal, block_k=bk, pv_int8=True)
            got = flash_mod.flash_star_attention(q, k, v, info, **kw)
            ref = flash_mod.flash_star_ref(q, k, v, info, **kw)
            torch.testing.assert_close(got.float(), ref.float(), **tol)


CARD_PAGED = [
    # w, bs, lens, (hq, hkv), d
    (63, 16, (600, 1000, 0, 1), (8, 2), 128),
    (3, 128, (300, 129), (4, 4), 64),
    (130, 1, (130, 0, 64), (32, 2), 16),
    (8, 48, (300, 47), (10, 1), 256),
    (20, 8, (0, 37, 129, 160), (16, 1), 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", split_mod.POOLS)
def test_paged_block_route_matches_plain_on_card(cuda, pool, dtype):
    rng = np.random.default_rng(68)
    for bits in ALL8:
        fmt = FixedPointFormat(*bits)
        for w, bs, lens, (hq, hkv), d in CARD_PAGED:
            ops = split_mod._operands(rng, pool, len(lens), w, bs, hq, hkv, d, lens)
            (q, kp, vp, tables, kvl), kw = split_mod._torch_args(ops, pool, cuda)
            q = q.to(dtype)
            if pool == "fp32":
                kp, vp = kp.to(dtype), vp.to(dtype)
            before = paged_mod.BLOCKED_LAUNCHES.count
            got = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=fmt, **kw)
            assert paged_mod.BLOCKED_LAUNCHES.count == before + (fmt.total_bits <= 5)
            ref = paged_mod.paged_attention_ref(q, kp, vp, tables, kvl, fmt=fmt, **kw)
            torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype),
                                       msg=lambda m: f"{bits} bs={bs} d={d} {m}")
            assert not got[kvl == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pool", split_mod.POOLS)
def test_paged_block_route_is_batch_invariant_on_card(cuda, pool):
    """At 3 bits a slot alone (one split: the direct route) and in a batch
    under a 70-block table (through the combine) give the same bits."""
    fmt = FixedPointFormat(2, 1)
    for slot in sorted(split_mod.INVARIANCE_SLOTS):
        alone, batch = split_mod._slot_views(np.random.default_rng(69), pool, 16,
                                             split_mod.INVARIANCE_LENS, 70, slot)
        outs = []
        for ops in (alone, batch):
            (q, kp, vp, tables, kvl), kw = split_mod._torch_args(ops, pool, cuda)
            outs.append(paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=fmt, **kw))
        assert torch.equal(outs[0][0], outs[1][slot]), slot


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gather", "onehot", "histogram"])
def test_star_softmax_kernel_matches_plain_at_every_format_on_card(cuda, mode):
    g = torch.Generator(device=cuda).manual_seed(70)
    x = torch.randn(4, 49152, device=cuda, generator=g) * 4
    x[:, :300] = -float("inf")
    for bits in ALL8:
        fmt = FixedPointFormat(*bits)
        got = soft_mod.star_softmax_kernel(x, fmt, mode=mode)
        torch.testing.assert_close(got, soft_mod.star_softmax_ref(x, fmt, mode=mode),
                                   rtol=1e-5, atol=1e-9)
