"""The split-KV paged decode kernel (``kernels/paged_attention``).

The CUDA kernel cuts each slot's rows at fixed offsets into splits of ``L``
= 64 rows (``SPLIT_ROWS``), computes each split's softmax and ``(m, l,
acc)``, and merges the splits in a combine pass.  Here, with no card:

* a float32 emulation of that split + combine (kept in this file, used by
  nothing else) is held against the plain gather version (``_tol``) and the
  JAX Pallas kernel in interpret mode (``atol`` 1e-5), STAR and exact, over
  fp and int8 / fp8 pools, with free slots, lens that end mid-split and
  empty trailing splits, at the kernel's ``L`` and once each at ``L`` of
  128 and 256 (online over 64-row tiles within a split).  Dyadic q and K (and
  power-of-two scales) keep every q.k exact in float32, so no score can snap
  to a neighbouring STAR level between the three;
* batch invariance in the emulation: a slot's output is bit-equal alone, in
  a batch of 4 and under a wider table, for a slot of many splits and for a
  short slot whose table alone makes one split (the kernel's direct route);
* the wrapper through a fake library: one library call per wrapper call with
  the leading pointers unchanged, ``splits = ceil(W * bs / L)``, a workspace
  smaller than the gathered window, one count per call and no host read.

``cuda``-marked tests hold the kernel to its plain version on the card over
many splits, and check batch invariance there bit for bit (they skip here).
"""

import importlib
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.core import kvquant
from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.core.lut import exp_lut
from repro_torch.kernels.paged_attention import kernel as paged_mod
from repro_torch.kernels.paged_attention.ref import gather_pages

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.paged_attention.kernel import paged_flash_attention as jax_paged
except ImportError:
    jnp = None

_FakeLib = importlib.import_module("test_torch_kernels")._FakeLib

TILE = 64  # rows of the online softmax's steps within a longer split
GRID_SENTINEL = -(1 << 24)
POOLS = ("fp32", "int8", "fp8_e4m3")


def _tol(dtype):
    # bf16 outputs: the kernel and the plain version round the same float32
    # value to bf16 only after summing in different orders (2 bf16 ulps)
    if dtype == torch.bfloat16:
        return dict(atol=8e-3, rtol=8e-3)
    return dict(atol=1e-5, rtol=1e-5)


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


# ---------------------------------------------------------------------------
# operands: dyadic q, K/V (or codes with power-of-two scales)


def _operands(rng, pool, s, w, bs, hq, hkv, d, lens):
    """numpy q, pools (codes as int8, or float32 values on the e4m3 grid),
    scales (None for an fp pool), tables and kv_valid.  Block 0 is scratch."""
    n = s * w + 1
    q = (rng.integers(-16, 17, (s, hq, d)) / 8.0).astype(np.float32)
    if pool == "fp32":
        kp, vp = ((rng.integers(-16, 17, (n, bs, hkv, d)) / 8.0).astype(np.float32)
                  for _ in range(2))
        scales = None
    else:
        if pool == "int8":
            kp, vp = (rng.integers(-127, 128, (n, bs, hkv, d)).astype(np.int8) for _ in range(2))
        else:
            vals = np.concatenate([2.0 ** np.arange(-3, 4), 1.5 * 2.0 ** np.arange(-3, 4)])
            vals = np.concatenate([vals, -vals]).astype(np.float32)
            kp, vp = (rng.choice(vals, (n, bs, hkv, d)) for _ in range(2))
        scales = tuple((2.0 ** rng.integers(-7, -3, (n, hkv))).astype(np.float32)
                       for _ in range(2))
    tables = rng.permutation(np.arange(1, n))[: s * w].reshape(s, w).astype(np.int32)
    return q, kp, vp, scales, tables, np.asarray(lens, np.int32)


def _torch_pool(a, pool, device=None):
    t = torch.as_tensor(a, device=device)
    return t.to(torch.float8_e4m3fn) if pool == "fp8_e4m3" else t


def _jax_pool(a, pool):
    return jnp.asarray(a).astype(jnp.float8_e4m3fn) if pool == "fp8_e4m3" else jnp.asarray(a)


def _torch_args(ops, pool, device=None):
    q, kp, vp, scales, tables, kvl = ops
    kw = {}
    if scales is not None:
        kw = dict(k_scale=torch.as_tensor(scales[0], device=device),
                  v_scale=torch.as_tensor(scales[1], device=device))
    args = (torch.as_tensor(q, device=device), _torch_pool(kp, pool, device),
            _torch_pool(vp, pool, device), torch.as_tensor(tables, device=device),
            torch.as_tensor(kvl, device=device))
    return args, kw


# ---------------------------------------------------------------------------
# the float32 emulation of split + combine


def _snap(x, scale):
    v = np.rint(x * np.float32(scale))
    v = np.where(np.isnan(v), GRID_SENTINEL, v)
    return np.clip(v, GRID_SENTINEL, -GRID_SENTINEL).astype(np.int64)


def _split_partial(qg, k, v, lut, scale, sm_scale):
    """One split's (m, l, acc) for the G q rows ``qg`` [G, D] over its live
    rows ``k``/``v`` [n, D], online over tiles of TILE rows."""
    g = qg.shape[0]
    star = lut is not None
    m = np.full(g, GRID_SENTINEL, np.int64) if star else np.full(g, -1e30, np.float32)
    l = np.zeros(g, np.float32)
    acc = np.zeros((g, qg.shape[1]), np.float32)
    for t0 in range(0, k.shape[0], TILE):
        kt, vt = k[t0:t0 + TILE], v[t0:t0 + TILE]
        sc = (qg @ kt.T).astype(np.float32) * np.float32(sm_scale)
        if star:
            top = lut.shape[0] - 1
            j = _snap(sc, scale)
            m_new = np.maximum(m, j.max(axis=1))
            r = lut[np.clip(m_new - m, 0, top)]
            p = lut[np.clip(m_new[:, None] - j, 0, top)]
        else:
            m_new = np.maximum(m, sc.max(axis=1))
            r = np.exp(m - m_new).astype(np.float32)
            p = np.exp(sc - m_new[:, None]).astype(np.float32)
        l = (l * r + p.sum(axis=1, dtype=np.float32)).astype(np.float32)
        acc = (acc * r[:, None] + p @ vt).astype(np.float32)
        m = m_new
    return m, l, acc


def _combine(parts, lut):
    """Merge partials in split order: m = max m_i, r_i = lut[min(m - m_i,
    top)] or exp(m_i - m), l = sum r_i l_i, acc = sum r_i acc_i."""
    star = lut is not None
    m = np.max([p[0] for p in parts], axis=0)
    l = np.zeros_like(parts[0][1])
    acc = np.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        if star:
            r = lut[np.minimum(m - m_i, lut.shape[0] - 1)]
        else:
            r = np.exp(m_i - m).astype(np.float32)
        l = (l + r * l_i).astype(np.float32)
        acc = (acc + r[:, None] * acc_i).astype(np.float32)
    return l, acc


def emulate_split_kv(q, kd, vd, kv_valid, fmt, sm_scale, rows, merge_empty=False):
    """``[S, Hq, D]`` float32 output of split-KV paged decode over the
    gathered (dequantized) rows ``kd``/``vd`` [S, W*bs, Hkv, D], with splits
    of ``rows`` rows, and the number of splits.  Splits past a slot's
    kv_valid hold the empty partial; the combine merges only the live ones
    unless ``merge_empty``.  With one split the partial is divided directly."""
    s_, hq, d = q.shape
    w_rows, hkv = kd.shape[1], kd.shape[2]
    g = hq // hkv
    lut = exp_lut(fmt).numpy() if fmt is not None else None
    scale = fmt.scale if fmt is not None else 1.0
    splits = max(1, math.ceil(w_rows / rows))
    out = np.zeros((s_, hq, d), np.float32)
    for s in range(s_):
        kv = min(max(int(kv_valid[s]), 0), w_rows)
        live = min(math.ceil(kv / rows), splits)
        for hk in range(hkv):
            qg = q[s, hk * g:(hk + 1) * g]
            parts = []
            for i in range(splits):
                lo, hi = i * rows, min((i + 1) * rows, kv)
                if hi > lo:
                    parts.append(_split_partial(qg, kd[s, lo:hi, hk], vd[s, lo:hi, hk],
                                                lut, scale, sm_scale))
                else:
                    m0 = (np.full(g, GRID_SENTINEL, np.int64) if lut is not None
                          else np.full(g, -1e30, np.float32))
                    parts.append((m0, np.zeros(g, np.float32), np.zeros((g, d), np.float32)))
            if splits == 1:
                _, l, acc = parts[0]
            elif live or merge_empty:
                l, acc = _combine(parts if merge_empty else parts[:live], lut)
            else:  # a free slot
                l, acc = np.zeros(g, np.float32), np.zeros((g, d), np.float32)
            out[s, hk * g:(hk + 1) * g] = acc / np.where(l <= 0, 1.0, l)[:, None]
    return out, splits


def _emulate(ops, pool, fmt, rows=paged_mod.SPLIT_ROWS, merge_empty=False):
    q, kp, vp, scales, tables, kvl = ops
    bs = kp.shape[1]
    if scales is not None:
        k_codes, v_codes = (kvquant.decode(_torch_pool(a, pool), torch.as_tensor(sc)[:, None, :, None])
                            for a, sc in ((kp, scales[0]), (vp, scales[1])))
    else:
        k_codes, v_codes = torch.as_tensor(kp), torch.as_tensor(vp)
    kd, vd = gather_pages(k_codes, v_codes, torch.as_tensor(tables))
    d = q.shape[2]
    return emulate_split_kv(q, kd.float().numpy(), vd.float().numpy(), kvl, fmt, d ** -0.5,
                            rows, merge_empty)


# ---------------------------------------------------------------------------
# (a) the emulation against the plain version and the JAX kernel

SPLIT_CASES = [
    # s, w, bs, hq, hkv, lens  (a 0 is a free slot); the first three are
    # test_torch_kernels.PAGED_CASES, one split each
    (3, 4, 8, 4, 2, (6, 25, 0)),
    (4, 3, 16, 8, 2, (16, 17, 48, 1)),
    (2, 5, 8, 4, 4, (40, 9)),
    # long: lens end mid-split, empty trailing splits, a free slot
    (2, 63, 16, 8, 2, (600, 1000)),
    (3, 8, 128, 4, 2, (600, 1000, 0)),
]
# (case, pool, STAR, L): every case and every pool in both modes, L 128
# and 256 once each
EMULATION_RUNS = [
    pytest.param(SPLIT_CASES[c], pool, star, rows,
                 id=f"case{c}-{pool}-{'star' if star else 'exact'}-L{rows}")
    for c, pool, star, rows in [
        (0, "fp32", True, 64), (0, "int8", False, 64),
        (1, "fp8_e4m3", True, 64), (1, "fp32", False, 64),
        (2, "int8", True, 64), (2, "fp8_e4m3", False, 64),
        (3, "fp32", True, 64), (3, "int8", False, 64), (3, "fp8_e4m3", True, 128),
        (4, "fp8_e4m3", False, 64), (4, "int8", True, 64), (4, "fp32", False, 256),
    ]
]


@pytest.mark.parametrize("case, pool, star, rows", EMULATION_RUNS)
def test_split_emulation_matches_plain(case, pool, star, rows):
    s, w, bs, hq, hkv, lens = case
    ops = _operands(np.random.default_rng(41), pool, s, w, bs, hq, hkv, 16, lens)
    fmt = FMT if star else None
    got, splits = _emulate(ops, pool, fmt, rows)
    assert splits == math.ceil(w * bs / rows)
    args, kw = _torch_args(ops, pool)
    ref = paged_mod.paged_attention_ref(*args, fmt=fmt, **kw)
    np.testing.assert_allclose(got, ref.numpy(), **_tol(torch.float32))
    for i in np.flatnonzero(ops[-1] == 0):
        assert not got[i].any()  # a free slot emits zeros


@pytest.mark.parametrize("case, pool, star, rows", EMULATION_RUNS)
def test_split_emulation_matches_pallas(case, pool, star, rows, jax_ref):
    s, w, bs, hq, hkv, lens = case
    q, kp, vp, scales, tables, kvl = ops = _operands(
        np.random.default_rng(42), pool, s, w, bs, hq, hkv, 16, lens)
    fmt = FMT if star else None
    got, _ = _emulate(ops, pool, fmt, rows)
    kw = {} if scales is None else dict(k_scale=jnp.asarray(scales[0]),
                                        v_scale=jnp.asarray(scales[1]))
    ref = np.asarray(jax_paged(
        jnp.asarray(q), _jax_pool(kp, pool), _jax_pool(vp, pool), jnp.asarray(tables),
        jnp.asarray(kvl), fmt=JFMT if star else None, interpret=True, **kw))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("star", [True, False])
def test_split_emulation_empty_splits_are_neutral(star):
    """Merging the empty trailing partials too gives the same bits as
    merging only the live splits, as the kernel's combine does."""
    ops = _operands(np.random.default_rng(43), "fp32", 3, 40, 16, 8, 2, 16, (130, 600, 0))
    fmt = FMT if star else None
    live, splits = _emulate(ops, "fp32", fmt)
    every, _ = _emulate(ops, "fp32", fmt, merge_empty=True)
    assert splits == 10
    assert np.array_equal(live, every)


# ---------------------------------------------------------------------------
# (b) batch invariance in the emulation


INVARIANCE_LENS = (1000, 0, 300, 17)
# slot: splits of the slot alone under its narrowest table (slot 3, 17
# rows in 2 blocks of 16: one split, the direct route)
INVARIANCE_SLOTS = {2: 5, 3: 1}


def _slot_views(rng, pool, bs, lens, w_wide, slot):
    """One slot's operands alone (the narrowest table that holds it), then
    the same slot in a batch of 4 under a table ``w_wide`` wide."""
    hq, hkv, d = 8, 2, 16
    ops = _operands(rng, pool, 4, w_wide, bs, hq, hkv, d, lens)
    q, kp, vp, scales, tables, kvl = ops
    w_alone = -(-int(kvl[slot]) // bs)
    alone = (q[slot:slot + 1], kp, vp, scales, tables[slot:slot + 1, :w_alone].copy(),
             kvl[slot:slot + 1])
    return alone, ops


@pytest.mark.parametrize("slot", sorted(INVARIANCE_SLOTS))
@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("pool", POOLS)
def test_split_emulation_is_batch_invariant(pool, star, slot):
    fmt = FMT if star else None
    alone, batch = _slot_views(np.random.default_rng(44), pool, 16, INVARIANCE_LENS, 70, slot)
    got_alone, splits_alone = _emulate(alone, pool, fmt)
    got_batch, splits_batch = _emulate(batch, pool, fmt)
    narrow = tuple(a[:, :63].copy() if i == 4 else a for i, a in enumerate(batch))
    got_narrow, _ = _emulate(narrow, pool, fmt)
    assert splits_alone == INVARIANCE_SLOTS[slot] and splits_batch == 18
    assert np.array_equal(got_alone[0], got_batch[slot])
    assert np.array_equal(got_narrow[slot], got_batch[slot])


# ---------------------------------------------------------------------------
# (c) the wrapper through a fake library


class _SplitFakeLib(_FakeLib):
    """Both C entries; records every call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def paged_attention_launch(self, *args):
        self.calls.append(("paged_attention_launch", args))
        return super().paged_attention_launch(*args)

    def paged_attention_quant_launch(self, *args):
        self.calls.append(("paged_attention_quant_launch", args))
        self.args = args
        return 0


def _no_host_read(*args, **kwargs):
    raise AssertionError("the paged wrapper read a value back from the device")


@pytest.mark.parametrize("pool", POOLS)
def test_wrapper_one_call_with_shape_only_splits(pool, monkeypatch):
    from test_torch_kernels import _OpLog

    s, w, bs, hq, hkv, d = 3, 40, 16, 8, 2, 16
    ops = _operands(np.random.default_rng(45), pool, s, w, bs, hq, hkv, d, (130, 600, 0))
    (q, kp, vp, tables, kvl), kw = _torch_args(ops, pool)
    lib = _SplitFakeLib()
    monkeypatch.setattr(paged_mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(paged_mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(paged_mod._cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.Tensor, "item", _no_host_read)
    monkeypatch.setattr(torch.Tensor, "tolist", _no_host_read)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_host_read)
    counter = paged_mod.LAUNCHES_QUANT if kw else paged_mod.LAUNCHES
    before = counter.count
    with _OpLog() as log:
        out = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=FMT, **kw)
    assert out.shape == (s, hq, d)
    assert counter.count == before + 1
    assert len(lib.calls) == 1
    entry, args = lib.calls[0]
    assert entry == ("paged_attention_quant_launch" if kw else "paged_attention_launch")
    assert args[:6] == (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
                        tables.data_ptr(), kvl.data_ptr())
    if kw:
        assert args[7:9] == (kw["k_scale"].data_ptr(), kw["v_scale"].data_ptr())
    splits = math.ceil(w * bs / 64)
    assert args[-1] == splits == 10
    window = s * w * bs * hkv * d
    sizes = [int(np.prod(sh)) for _, shapes in log.calls for sh in shapes]
    workspace = s * hq * splits * (d + 2)
    assert workspace in sizes and args[-2] is not None
    assert max(sizes) < window
    names = [n for n, _ in log.calls]
    assert not [n for n in names if any(g in n for g in ("index", "gather", "take"))], names


def test_wrapper_single_split_needs_no_workspace(monkeypatch):
    ops = _operands(np.random.default_rng(46), "fp32", 3, 4, 16, 4, 2, 16, (6, 64, 0))
    (q, kp, vp, tables, kvl), _ = _torch_args(ops, "fp32")
    lib = _SplitFakeLib()
    monkeypatch.setattr(paged_mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(paged_mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(paged_mod._cuda, "stream_handle", lambda device: 0)
    paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=None)
    args = lib.calls[0][1]
    assert args[-2:] == (None, 1)


def test_wrapper_refuses_misaligned_pools_before_any_launch(monkeypatch):
    ops = _operands(np.random.default_rng(47), "fp32", 2, 4, 16, 4, 2, 16, (6, 40))
    (q, kp, vp, tables, kvl), _ = _torch_args(ops, "fp32")
    flat = torch.zeros(kp.numel() + 1)
    kp_off = flat[1:].view(kp.shape)
    kp_off.copy_(kp)
    lib = _SplitFakeLib()
    monkeypatch.setattr(paged_mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(paged_mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(paged_mod._cuda, "stream_handle", lambda device: 0)
    before = paged_mod.LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte aligned k_pages"):
        paged_mod.paged_flash_attention(q, kp_off, vp, tables, kvl, fmt=FMT)
    assert lib.calls == [] and paged_mod.LAUNCHES.count == before


def test_split_constants_match_the_source():
    src = paged_mod.SOURCE.read_text()
    assert int(re.search(r"constexpr int SPLIT_ROWS = (\d+);", src).group(1)) == \
        paged_mod.SPLIT_ROWS == 64
    assert int(re.search(r"constexpr int MAXG = (\d+);", src).group(1)) == paged_mod.MAX_GROUP
    # the tick (W 34, bs 16), a short table, half-page splits at bs 128, bs 1
    assert [paged_mod.num_splits(w, bs) for w, bs in ((34, 16), (2, 16), (3, 128), (130, 1))] \
        == [9, 1, 6, 3]
    assert paged_mod.num_splits(0, 16) == 1


# ---------------------------------------------------------------------------
# on the card: many splits, and batch invariance bit for bit

CARD_CASES = [
    # w, bs, lens
    (63, 16, (600, 1000, 0, 1)),
    (3, 128, (300, 129)),  # splits of half a page
    (130, 1, (130, 0, 64)),  # 64 pages a split
    (8, 48, (300, 47)),  # splits that start inside a page
]
CARD_GROUPS = ((2, 2), (8, 2), (32, 2))  # (hq, hkv): G 1, 4, 16


def _card_cases():
    for w, bs, lens in CARD_CASES:
        for d in (16, 32, 64, 128):
            for hq, hkv in CARD_GROUPS:
                yield (len(lens), w, bs, hq, hkv, d, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False])
def test_paged_split_kernel_matches_plain_on_card(cuda, dtype, star):
    rng = np.random.default_rng(48)
    before = paged_mod.LAUNCHES.count
    n = 0
    for s, w, bs, hq, hkv, d, lens in _card_cases():
        ops = _operands(rng, "fp32", s, w, bs, hq, hkv, d, lens)
        (q, kp, vp, tables, kvl), _ = _torch_args(ops, "fp32", cuda)
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        kw = dict(fmt=FMT if star else None)
        got = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, **kw)
        ref = paged_mod.paged_attention_ref(q, kp, vp, tables, kvl, **kw)
        torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
        assert not got[kvl == 0].any()
        n += 1
    assert paged_mod.LAUNCHES.count - before == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("pool", ["int8", "fp8_e4m3"])
def test_quant_paged_split_kernel_matches_plain_on_card(cuda, pool, star, dtype):
    rng = np.random.default_rng(49)
    for s, w, bs, hq, hkv, d, lens in _card_cases():
        ops = _operands(rng, pool, s, w, bs, hq, hkv, d, lens)
        (q, kp, vp, tables, kvl), kw = _torch_args(ops, pool, cuda)
        q = q.to(dtype)
        kw.update(fmt=FMT if star else None)
        got = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, **kw)
        ref = paged_mod.paged_attention_ref(q, kp, vp, tables, kvl, **kw)
        torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
        assert not got[kvl == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("slot", sorted(INVARIANCE_SLOTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("pool", POOLS)
def test_paged_split_kernel_is_batch_invariant_on_card(cuda, pool, star, dtype, slot):
    """A slot of a batch of 4 under a 70-block table (18 splits, through the
    combine) gives the same bits as the slot alone under the narrowest table
    that holds it, and as the batch under a 63-block table.  Slot 3 (17
    rows) alone has one split: the split kernel writes its output directly."""
    alone, batch = _slot_views(np.random.default_rng(50), pool, 16, INVARIANCE_LENS, 70, slot)
    outs = []
    for ops in (alone, batch, tuple(a[:, :63].copy() if i == 4 else a
                                    for i, a in enumerate(batch))):
        (q, kp, vp, tables, kvl), kw = _torch_args(ops, pool, cuda)
        if pool == "fp32":
            kp, vp = kp.to(dtype), vp.to(dtype)
        outs.append(paged_mod.paged_flash_attention(q.to(dtype), kp, vp, tables, kvl,
                                                    fmt=FMT if star else None, **kw))
    assert paged_mod.num_splits(alone[4].shape[1], 16) == INVARIANCE_SLOTS[slot]
    assert torch.equal(outs[0][0], outs[1][slot])
    assert torch.equal(outs[2][slot], outs[1][slot])
