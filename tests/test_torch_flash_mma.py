"""flash_star's bfloat16 tensor-core kernel, on the CPU: the three-piece
split of P that its P.V mirrors (``kernels.flash_star.ref``), and how
``chip_smoke.py``'s count of unequal bf16 outputs tells that P.V from one
on P rounded to bf16; the wrapper's routing by type and its alignment
check (through a fake library, as
``test_paged_wrapper_builds_no_gathered_window`` fakes it), with the
float32 and int8 routes beside it; and the plain
version against the JAX Pallas kernel in interpret mode at the new kernel's
head dimension and across its 64-row tiles.  On the card (marked ``cuda``):
the main path's views through the kernel against the plain route; every
case and head dimension against the plain version is in
``tests/test_torch_kernels.py``.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.core.fixedpoint import FORMAT_COLA, FORMAT_CNEWS, FORMAT_MRPC
from repro_torch.core.lut import exp_lut

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
except ImportError:
    jnp = None

flash_mod = importlib.import_module("repro_torch.kernels.flash_star.kernel")
ref_mod = importlib.import_module("repro_torch.kernels.flash_star.ref")

SUBNORMAL_BOUND = 2.0 ** -134  # half the spacing of the bf16 subnormals


def _pieces_sum(p):
    hi, mid, lo = ref_mod.split_bf16x3(p)
    for piece in (hi, mid, lo):
        assert piece.dtype == torch.bfloat16
    return hi.double() + mid.double() + lo.double()


def _pv_three_piece(p, v):
    """``p @ v`` as the bf16 kernel forms it: the three bf16 pieces of
    ``p`` times bf16 ``v`` (each product exact in float32), summed in
    float32."""
    vf = v.to(torch.bfloat16).float()
    hi, mid, lo = ref_mod.split_bf16x3(p)
    return hi.float() @ vf + mid.float() @ vf + lo.float() @ vf


# ---------------------------------------------------------------------------
# (a) the three-piece split


@pytest.mark.parametrize("fmt", [FORMAT_CNEWS, FORMAT_MRPC, FORMAT_COLA], ids=str)
def test_split_is_exact_on_every_lut_entry(fmt):
    """Every probability STAR can produce is a LUT entry: its pieces sum to
    it bit for bit (every entry of these formats is above 2^-100)."""
    table = exp_lut(fmt)
    assert float(table.min()) >= 2.0 ** -100
    assert torch.equal(_pieces_sum(table), table.double())


def test_split_is_exact_for_exp_down_to_2_pow_minus_100():
    """The exact softmax's p = expf(s - m) over a sweep of s - m from 0 down
    to where p reaches 2^-100, plus random float32 mantissas at every
    exponent in [-100, 0]: exact; below 2^-100, within 2^-134."""
    x = torch.linspace(0.0, 100 * np.log(2.0), 200_001, dtype=torch.float64)
    p = torch.exp(-x).float()
    p = p[p >= 2.0 ** -100]
    assert torch.equal(_pieces_sum(p), p.double())
    rng = np.random.default_rng(21)
    mant = rng.integers(0, 1 << 23, 100_000, dtype=np.int64)
    expo = rng.integers(127 - 100, 127 + 1, 100_000, dtype=np.int64)
    bits = (expo << 23 | mant).astype(np.uint32)
    r = torch.from_numpy(bits.view(np.float32).copy())
    assert torch.equal(_pieces_sum(r), r.double())
    tiny = torch.exp2(-torch.linspace(100.0, 149.0, 50_001, dtype=torch.float64)).float()
    tiny = tiny[tiny < 2.0 ** -100]
    err = (_pieces_sum(tiny) - tiny.double()).abs()
    assert float(err.max()) <= SUBNORMAL_BOUND


@pytest.mark.parametrize("star", [True, False])
def test_pv_through_the_pieces_is_the_float64_product_rounded(star):
    """P.V through the three pieces, summed in float32, against the float64
    product rounded once: |err| <= gamma * sum_k |p v| with gamma = (3 K + 2)
    2^-24, the float32 summation bound of 3 K exact products (K = 512)."""
    rng = np.random.default_rng(22)
    kdim, n = 512, 64
    if star:
        table = exp_lut(FMT)
        p = table[torch.as_tensor(rng.integers(0, FMT.num_levels, (32, kdim)))]
    else:
        p = torch.exp(-torch.as_tensor(rng.exponential(4.0, (32, kdim)), dtype=torch.float32))
    v = torch.as_tensor(rng.normal(size=(kdim, n)), dtype=torch.float32).to(torch.bfloat16)
    got = _pv_three_piece(p, v)
    exact = p.double() @ v.double()
    bound = (3 * kdim + 2) * 2.0 ** -24 * (p.double().abs() @ v.double().abs())
    assert got.dtype == torch.float32
    assert bool(((got.double() - exact).abs() <= bound).all())
    # and far closer than P rounded to bf16 once
    rounded = p.to(torch.bfloat16).double() @ v.double()
    assert float((got.double() - exact).abs().max()) < 0.01 * float((rounded - exact).abs().max())


def _chip_smoke_bound():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.BF16_DIFF_BOUND


def _tile_loop(q, k, v, fmt, pv):
    """The bf16 kernel's online softmax in float32 over 64-row KV tiles
    (causal, Tq == Tk), with ``pv(p, v_tile)`` forming each tile's P.V;
    rounded to bf16 once at the end."""
    b, hq, t, d = q.shape
    g = hq // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, 1) for x in (k, v))
    rows = torch.arange(t)
    o = torch.zeros(b, hq, t, d)
    l = torch.zeros(b, hq, t)
    if fmt is not None:
        lut, top = exp_lut(fmt), fmt.num_levels - 1
        m = torch.full((b, hq, t), -(2 ** 40), dtype=torch.int64)
    else:
        m = torch.full((b, hq, t), -1e30)
    for c0 in range(0, t, 64):
        s = (qf @ kf[:, :, c0:c0 + 64].transpose(-1, -2)) * d ** -0.5
        live = rows[c0:c0 + 64][None, :] <= rows[:, None]
        if fmt is not None:
            jg = torch.where(live, torch.round(s * fmt.scale).long(), m.new_tensor(-(2 ** 40)))
            m_new = torch.maximum(m, jg.max(-1).values)
            r = lut[(m_new - m).clamp(0, top)]
            p = torch.where(live, lut[(m_new[..., None] - jg).clamp(0, top)], 0.0)
        else:
            m_new = torch.maximum(m, torch.where(live, s, -1e30).max(-1).values)
            r = torch.exp(m - m_new)
            p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
        m = m_new
        l = l * r + p.sum(-1)
        o = o * r[..., None] + pv(p, vf[:, :, c0:c0 + 64])
    return (o / torch.where(l <= 0, 1.0, l)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("star", [True, False])
def test_bf16_diff_bound_tells_three_pieces_from_p_rounded_to_bf16(star):
    """chip_smoke.py holds the card's bf16 output to the plain version's in
    all but BF16_DIFF_BOUND of its elements.  The kernel's tile loop,
    emulated here in float32, meets that bound ten times over with P.V on
    the three pieces (only float32 sums reordered), and a P.V on P rounded
    to bf16 misses it more than tenfold."""
    bound = _chip_smoke_bound()
    rng = np.random.default_rng(28)
    b, hq, hkv, t, d = 1, 4, 1, 512, 128
    q, k, v = (torch.as_tensor(rng.normal(size=sh), dtype=torch.float32).to(torch.bfloat16)
               for sh in ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d)))
    info = torch.tensor([0, t], dtype=torch.int32)
    fmt = FMT if star else None
    ref = ref_mod.flash_star_ref(q, k, v, info, fmt=fmt, causal=True)
    three = _tile_loop(q, k, v, fmt, lambda p, vt: _pv_three_piece(p, vt.to(torch.bfloat16)))
    hi_only = _tile_loop(q, k, v, fmt, lambda p, vt: p.to(torch.bfloat16).float() @ vt)
    share_three = float((three != ref).float().mean())
    share_hi = float((hi_only != ref).float().mean())
    assert share_three <= bound / 10, share_three
    assert share_hi >= 10 * bound, share_hi


# ---------------------------------------------------------------------------
# (b) routing by type and the alignment check


class _FakeLib:
    ENTRIES = ("flash_star_mma_launch", "flash_star_tf32_launch",
               "flash_star_quantize_v_launch", "flash_star_pv_int8_launch")

    def __init__(self):
        self.calls = []
        for name in self.ENTRIES:
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(flash_mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(flash_mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(flash_mod._cuda, "stream_handle", lambda device: 0)
    return lib


def _operands(dtype, b=2, hq=4, hkv=2, t=70, d=16):
    g = torch.Generator().manual_seed(23)
    q, k, v = (torch.randn(sh, generator=g).to(dtype) for sh in
               ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d)))
    return q, k, v, torch.tensor([0] + [t] * b, dtype=torch.int32)


@pytest.mark.parametrize("dtype,pv_int8,entries,dtype_code,bk", [
    (torch.bfloat16, False, ["flash_star_mma_launch"], None, None),
    (torch.float32, False, ["flash_star_tf32_launch"], None, None),
    (torch.bfloat16, True, ["flash_star_quantize_v_launch", "flash_star_pv_int8_launch"], 1, 64),
    (torch.float32, True, ["flash_star_quantize_v_launch", "flash_star_pv_int8_launch"], 0, 64),
])
def test_wrapper_routes_by_type(fake_lib, dtype, pv_int8, entries, dtype_code, bk):
    """bf16 to the mma kernel, float32 to the tf32 kernel (the same
    arguments, no dtype code, no int8 block); pv_int8 to V's pre-pass and
    then the s8 attention over its workspace (sized from the shapes alone),
    one launch count for the pair."""
    q, k, v, info = _operands(dtype)
    before = (flash_mod.LAUNCHES.count, flash_mod.PV_INT8_LAUNCHES.count)
    out = flash_mod.flash_star_attention(q, k, v, info, fmt=FMT, block_k=64, pv_int8=pv_int8)
    assert out.shape == q.shape and out.dtype == dtype
    assert [name for name, _ in fake_lib.calls] == entries
    after = (flash_mod.LAUNCHES.count, flash_mod.PV_INT8_LAUNCHES.count)
    assert after == (before[0] + (not pv_int8), before[1] + pv_int8)
    args = fake_lib.calls[-1][1]
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if not pv_int8:
        assert len(args) == 6 + 12 + 6 + 5 + 1  # no dtype code, no int8 block
        return
    pre = fake_lib.calls[0][1]
    b, hkv, tk, d = k.shape
    # v, its strides, B Hkv Tk D, dtype, bk, codes, scales, stream
    assert pre[:4] == (v.data_ptr(), *v.stride()[:3])
    assert pre[4:10] == (b, hkv, tk, d, dtype_code, bk)
    assert (args[24], args[-4]) == (dtype_code, bk)
    assert args[-3:-1] == pre[-3:-1]  # the attention reads the pre-pass's workspace


def _misaligned_views():
    b, hq, t, d = 1, 4, 70, 16
    flat = torch.zeros(b * hq * t * d + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(b, hq, t, d)  # base pointer 2 bytes off
    padded = torch.zeros(b, hq, t, d + 1, dtype=torch.bfloat16)[..., :d]  # T stride 34 bytes
    return {"storage offset": shifted, "T stride": padded}


@pytest.mark.parametrize("which", ["storage offset", "T stride"])
@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_misaligned_bf16_view_raises_before_any_launch(fake_lib, which, operand):
    q, k, v, _ = _operands(torch.bfloat16, b=1, hq=4, hkv=4, t=70, d=16)
    ops = {"q": q, "k": k, "v": v}
    ops[operand] = _misaligned_views()[which]
    info = torch.tensor([0, 70], dtype=torch.int32)
    with pytest.raises(ValueError, match=f"16-byte aligned {operand}"):
        flash_mod.flash_star_attention(ops["q"], ops["k"], ops["v"], info, fmt=FMT)
    assert fake_lib.calls == []


def test_misaligned_float32_and_int8_views_are_not_the_bf16_kernels_concern(fake_lib):
    """The float32 and int8 kernels copy 16-byte pieces too: the same views
    are refused by the same check, for float32 (a T stride of 68 bytes) and
    for bf16 q/k/v on the int8 route, before any launch."""
    view = _misaligned_views()["T stride"]
    view32 = torch.zeros(1, 4, 70, 17)[..., :16]  # T stride 68 bytes
    info = torch.tensor([0, 70], dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte aligned q"):
        flash_mod.flash_star_attention(view32, view32, view32, info, fmt=FMT)
    with pytest.raises(ValueError, match="16-byte aligned q"):
        flash_mod.flash_star_attention(view, view, view, info, fmt=FMT, pv_int8=True)
    with pytest.raises(ValueError, match="16-byte aligned k"):
        q32 = torch.zeros(1, 4, 70, 16)
        flash_mod.flash_star_attention(q32, view32, q32, info, fmt=FMT, pv_int8=True)
    assert fake_lib.calls == []


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "flash_star_mma_launch"),
                                         (torch.float32, "flash_star_tf32_launch")])
@pytest.mark.parametrize("d", [16, 128])
def test_main_path_transposed_views_pass_the_check(fake_lib, d, dtype, entry):
    """``ops.attention``'s pallas route hands ``[B, T, H, D]`` activations
    to the kernel as heads-major views without a copy; they pass, in bf16
    and in float32."""
    from repro_torch import ops
    from repro_torch.ops.specs import AttentionSpec, SoftmaxSpec

    b, t, hq, hkv = 2, 70, 8, 2
    g = torch.Generator().manual_seed(24)
    q, k, v = (torch.randn(sh, generator=g).to(dtype) for sh in
               ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    spec = AttentionSpec(impl="pallas", softmax=SoftmaxSpec(kind="star", precision=FMT))
    out = ops.attention(q, k, v, spec, causal=True)
    assert out.shape == q.shape
    assert [name for name, _ in fake_lib.calls] == [entry]
    assert fake_lib.calls[0][1][6:9] == q.transpose(1, 2).stride()[:3]


@pytest.mark.cuda
@pytest.mark.parametrize("star", [True, False])
def test_main_path_views_run_the_tensor_core_kernel_on_card(star):
    """On the card, ``ops.attention``'s pallas route hands the transposed
    bf16 views to the tensor-core kernel (one ``flash_star`` launch) and
    its output holds to the plain version within two bf16 ulps."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    from repro_torch import ops
    from repro_torch.ops.specs import AttentionSpec, SoftmaxSpec

    b, t, hq, hkv, d = 2, 200, 8, 2, 128
    g = torch.Generator().manual_seed(26)
    q, k, v = ((torch.randint(-16, 17, sh, generator=g) / 8.0).to("cuda", torch.bfloat16)
               for sh in ((b, t, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    softmax = SoftmaxSpec(kind="star", precision=FMT) if star else SoftmaxSpec(kind="exact")
    spec = AttentionSpec(impl="pallas", softmax=softmax)
    before = flash_mod.LAUNCHES.count
    got = ops.attention(q, k, v, spec, causal=True)
    assert flash_mod.LAUNCHES.count == before + 1
    ref = ops.attention(q, k, v, AttentionSpec(impl="reference", softmax=softmax), causal=True)
    torch.testing.assert_close(got.float(), ref.float(), atol=8e-3, rtol=8e-3)


@pytest.mark.cuda
def test_wide_lut_is_read_from_global_memory_on_card():
    """A 13-bit format (8192 levels) does not fit the kernel's shared-memory
    LUT: the kernel reads it from global memory, with the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    from repro_torch.core.fixedpoint import FixedPointFormat

    fmt = FixedPointFormat(int_bits=6, frac_bits=7)
    assert fmt.num_levels > 4096
    g = torch.Generator().manual_seed(27)
    q, k, v = ((torch.randint(-16, 17, sh, generator=g) / 8.0).to("cuda", torch.bfloat16)
               for sh in ((1, 4, 130, 64), (1, 2, 130, 64), (1, 2, 130, 64)))
    info = torch.tensor([0, 130], dtype=torch.int32, device="cuda")
    got = flash_mod.flash_star_attention(q, k, v, info, fmt=fmt)
    ref = flash_mod.flash_star_ref(q, k, v, info, fmt=fmt)
    torch.testing.assert_close(got.float(), ref.float(), atol=8e-3, rtol=8e-3)


# ---------------------------------------------------------------------------
# (c) the plain version against the JAX kernel at D = 128, across 64-row tiles


def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


MMA_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 4, 2, 130, 130, True, None, 0, None),      # T = 2 tiles + 2 rows
    (2, 4, 2, 65, 130, True, 48, 65, (130, 100)),  # q_offset, window, ragged
]


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs JAX (the reference)")


@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("case", MMA_CASES)
def test_flash_star_plain_matches_pallas_at_d128(case, star, jax_ref):
    b, hq, hkv, tq, tk, causal, window, q_off, kvl = case
    rng = np.random.default_rng(25)
    d = 128
    q, k, v = _dyadic(rng, (b, hq, tq, d)), _dyadic(rng, (b, hkv, tk, d)), _dyadic(rng, (b, hkv, tk, d))
    info = np.array([q_off] + list(kvl or [tk] * b), np.int32)
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(info),
        fmt=JFMT if star else None, causal=causal, sliding_window=window,
        block_q=64, block_k=64, interpret=True))
    got = flash_mod.flash_star_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(info),
        fmt=FMT if star else None, causal=causal, sliding_window=window, block_k=64)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
