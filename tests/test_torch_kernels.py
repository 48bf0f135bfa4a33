"""Each Hopper kernel's plain version against its JAX Pallas kernel (run in
interpret mode, as the reference's own tests run it), plus the kernels
against their plain versions on the card (marked ``cuda``: they skip where
there is no card).

Attention inputs are multiples of 1/8 so every q.k dot product is exact in
float32 whatever the summation order: the comparison then tests the
algorithm, and no score can snap to a neighbouring grid level between two
implementations.  Outputs hold to ``atol=1e-5``.
"""

import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
    from repro.kernels.paged_attention.kernel import paged_flash_attention as jax_paged
    from repro.kernels.star_softmax.kernel import star_softmax_pallas as jax_star

    jax_core_softmax = importlib.import_module("repro.core.star_softmax")
except ImportError:
    jnp = None

flash_mod = importlib.import_module("repro_torch.kernels.flash_star.kernel")
paged_mod = importlib.import_module("repro_torch.kernels.paged_attention.kernel")
soft_mod = importlib.import_module("repro_torch.kernels.star_softmax.kernel")

ATOL = 1e-5


def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


def _tol(dtype):
    # bf16 outputs: the kernel and the plain version round the same float32
    # value to bf16 only after summing in different orders (2 bf16 ulps)
    if dtype == torch.bfloat16:
        return dict(atol=8e-3, rtol=8e-3)
    return dict(atol=ATOL, rtol=1e-5)


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
# flash_star

FLASH_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 4, 2, 13, 13, True, None, 0, None),       # T not a multiple of the block
    (2, 8, 2, 9, 29, True, None, 20, (29, 17)),   # q_offset, ragged, GQA 8:2
    (2, 4, 2, 19, 19, False, None, 0, (19, 6)),   # ragged, non-causal
    (1, 4, 4, 24, 24, True, 7, 0, None),          # sliding window
]


@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_star_plain_matches_pallas(case, star, jax_ref):
    b, hq, hkv, tq, tk, causal, window, q_off, kvl = case
    rng = np.random.default_rng(11)
    d = 16
    q, k, v = _dyadic(rng, (b, hq, tq, d)), _dyadic(rng, (b, hkv, tk, d)), _dyadic(rng, (b, hkv, tk, d))
    info = np.array([q_off] + list(kvl or [tk] * b), np.int32)
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(info),
        fmt=JFMT if star else None, causal=causal, sliding_window=window,
        block_q=8, block_k=8, interpret=True))
    got = flash_mod.flash_star_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(info),
        fmt=FMT if star else None, causal=causal, sliding_window=window, block_k=8)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# paged attention


def _paged_operands(rng, s, w, bs, hq, hkv, d, lens):
    n = s * w + 1  # block 0 is scratch
    q = _dyadic(rng, (s, hq, d))
    kp, vp = _dyadic(rng, (n, bs, hkv, d)), _dyadic(rng, (n, bs, hkv, d))
    tables = rng.permutation(np.arange(1, n))[: s * w].reshape(s, w).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


PAGED_CASES = [
    # s, w, bs, hq, hkv, lens  (a 0 is a free slot)
    (3, 4, 8, 4, 2, (6, 25, 0)),
    (4, 3, 16, 8, 2, (16, 17, 48, 1)),
    (2, 5, 8, 4, 4, (40, 9)),
]


@pytest.mark.parametrize("star", [True, False])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_plain_matches_pallas(case, star, jax_ref):
    s, w, bs, hq, hkv, lens = case
    rng = np.random.default_rng(12)
    q, kp, vp, tables, kvl = _paged_operands(rng, s, w, bs, hq, hkv, 16, lens)
    ref = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(kvl), fmt=JFMT if star else None, interpret=True))
    got = paged_mod.paged_flash_attention(
        torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
        torch.as_tensor(tables), torch.as_tensor(kvl), fmt=FMT if star else None)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    for i in np.flatnonzero(kvl == 0):
        assert not got[i].any()  # a free slot emits zeros


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = [tuple(o.shape) for o in (out if isinstance(out, (tuple, list)) else [out])
                  if isinstance(o, torch.Tensor)]
        self.calls.append((str(func), shapes))
        return out


class _FakeLib:
    def __init__(self):
        self.args = None

    def paged_attention_launch(self, *args):
        self.args = args
        return 0


def test_paged_wrapper_builds_no_gathered_window(monkeypatch):
    """On the card the wrapper hands pools and tables to the kernel as they
    are: it calls no gather/index op and makes no [S, W*bs, Hkv, D] tensor
    (the library call is stubbed here, where there is no card)."""
    rng = np.random.default_rng(13)
    s, w, bs, hq, hkv, d = 3, 4, 8, 4, 2, 16
    q, kp, vp, tables, kvl = (torch.as_tensor(a) for a in
                              _paged_operands(rng, s, w, bs, hq, hkv, d, (6, 25, 0)))
    lib = _FakeLib()
    monkeypatch.setattr(paged_mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(paged_mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(paged_mod._cuda, "stream_handle", lambda device: 0)
    with _OpLog() as log:
        out = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=FMT)
    assert out.shape == (s, hq, d)
    ops_called = [name for name, _ in log.calls]
    assert not [n for n in ops_called if any(g in n for g in ("index", "gather", "take"))], ops_called
    window = s * w * bs * hkv * d
    assert all(int(np.prod(sh)) < window for _, shapes in log.calls for sh in shapes)
    assert lib.args[1:3] == (kp.data_ptr(), vp.data_ptr())
    assert lib.args[4:6] == (tables.data_ptr(), kvl.data_ptr())


def test_paged_quantized_pools_wait_for_their_port():
    """Their port has landed: scaled int8 pools no longer raise
    CapabilityError; on the CPU they run the dequantizing plain version
    (the JAX comparison is in tests/test_torch_kvquant.py)."""
    q = torch.ones(2, 2, 16)
    codes = torch.full((3, 4, 2, 16), 4, dtype=torch.int8)
    out = paged_mod.paged_flash_attention(
        q, codes, codes, torch.ones(2, 1, dtype=torch.int32), torch.ones(2, dtype=torch.int32),
        fmt=FMT, k_scale=torch.ones(3, 2), v_scale=torch.full((3, 2), 0.5))
    assert torch.equal(out, torch.full((2, 2, 16), 2.0))  # one valid row: 4 * 0.5


# ---------------------------------------------------------------------------
# star softmax


@pytest.mark.parametrize("shape", [(7, 50), (2, 3, 129), (300,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_star_softmax_plain_matches_pallas(shape, dtype, jax_ref):
    x = (np.random.default_rng(14).normal(size=shape) * 5).astype(np.float32)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    ref = np.asarray(jax_star(xj, fmt=JFMT, interpret=True))
    got = soft_mod.star_softmax_kernel(xt, FMT)
    assert got.dtype == torch.float32 and got.shape == xt.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=1e-5)


def test_star_softmax_neg_inf_follows_the_reference_engine(jax_ref):
    """``-inf`` columns get the last level (~1.5e-28), as the JAX
    ``reference`` engine gives; the JAX Pallas kernel wraps them to level 0
    (a fault of the reference's kernel, recorded in ROADMAP.md) and the port
    does not copy it."""
    x = np.array([[0.0, 1.0, -np.inf, -np.inf], [2.0, -np.inf, 0.5, -1e30]], np.float32)
    got = soft_mod.star_softmax_kernel(torch.as_tensor(x), FMT).numpy()
    ref = np.asarray(jax_core_softmax.star_softmax(jnp.asarray(x), JFMT, mode="gather"))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[0, 2:], 1.505494e-28, rtol=1e-5)
    wrapped = np.asarray(jax_star(jnp.asarray(x), fmt=JFMT, interpret=True))
    assert wrapped[0, 2] > 0.1  # the reference kernel's wrap, not copied


def test_star_softmax_other_modes_wait_for_their_port():
    """The ``onehot`` and ``histogram`` modes are ported now (both run the
    CUDA cluster kernel, as ``gather`` does): on a CPU tensor
    the wrapper runs that mode's plain version, and an unknown mode is
    refused."""
    x = torch.as_tensor(np.random.default_rng(17).normal(size=(3, 40)) * 4, dtype=torch.float32)
    for mode in ("onehot", "histogram"):
        got = soft_mod.star_softmax_kernel(x, FMT, mode=mode)
        assert torch.equal(got, soft_mod.star_softmax_ref(x, FMT, mode=mode))
    with pytest.raises(ValueError, match="mode"):
        soft_mod.star_softmax_kernel(x, FMT, mode="bogus")


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version


CARD_FLASH_CASES = FLASH_CASES + [
    # across the bf16 kernel's 64-row q and KV tiles
    (1, 4, 2, 130, 130, True, None, 0, None),
    (2, 4, 2, 65, 265, True, None, 200, (265, 190)),  # q_offset, ragged
    (1, 4, 2, 200, 200, True, 50, 0, None),           # sliding window at Tk 200
    (1, 32, 8, 130, 130, True, None, 0, None),        # GQA 32:8
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False])
def test_flash_star_kernel_matches_plain_on_card(cuda, dtype, star):
    """Every case at every head dimension, heads-major and as the transposed
    ``[B, T, H, D]`` views that ``ops.attention`` passes."""
    rng = np.random.default_rng(15)
    for b, hq, hkv, tq, tk, causal, window, q_off, kvl in CARD_FLASH_CASES:
        for d in (16, 32, 64, 128):
            for transposed in (False, True):
                shapes = ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
                if transposed:
                    shapes = [(sh[0], sh[2], sh[1], sh[3]) for sh in shapes]
                q, k, v = (torch.as_tensor(_dyadic(rng, sh), device=cuda).to(dtype)
                           for sh in shapes)
                if transposed:
                    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
                info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32,
                                    device=cuda)
                kw = dict(fmt=FMT if star else None, causal=causal, sliding_window=window)
                got = flash_mod.flash_star_attention(q, k, v, info, **kw)
                ref = flash_mod.flash_star_ref(q, k, v, info, **kw)
                torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
def test_flash_star_misaligned_bf16_view_raises_on_card(cuda):
    """The bf16 kernel copies 16-byte pieces: a view 2 bytes off a 16-byte
    boundary is refused with the named error, and nothing launches."""
    b, h, t, d = 1, 4, 70, 16
    flat = torch.zeros(b * h * t * d + 1, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(b, h, t, d)
    k = v = torch.zeros((b, h, t, d), dtype=torch.bfloat16, device=cuda)
    info = torch.tensor([0, t], dtype=torch.int32, device=cuda)
    before = flash_mod.LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte aligned q"):
        flash_mod.flash_star_attention(q, k, v, info, fmt=FMT)
    assert flash_mod.LAUNCHES.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False])
def test_paged_kernel_matches_plain_on_card(cuda, dtype, star):
    rng = np.random.default_rng(16)
    for s, w, bs, hq, hkv, lens in PAGED_CASES:
        q, kp, vp, tables, kvl = (torch.as_tensor(a, device=cuda) for a in
                                  _paged_operands(rng, s, w, bs, hq, hkv, 64, lens))
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        kw = dict(fmt=FMT if star else None)
        got = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, **kw)
        ref = paged_mod.paged_attention_ref(q, kp, vp, tables, kvl, **kw)
        torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
def test_star_softmax_kernel_matches_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(5, 49152, device=cuda, generator=g) * 4
    x[:, :300] = -float("inf")
    x[1, 7] = float("nan")
    got = soft_mod.star_softmax_kernel(x, FMT)
    torch.testing.assert_close(got, soft_mod.star_softmax_ref(x, FMT), rtol=1e-5, atol=1e-7)


MILD_FAULT = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
                  adc_offset_sigma=0.1, read_disturb=0.01, seed=7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,faulty", [("histogram", False), ("gather", True),
                                         ("onehot", True), ("histogram", True)])
def test_star_softmax_lut_kernel_matches_plain_on_card(cuda, dtype, mode, faulty):
    """The CUDA LUT softmax (clean histogram, every faulty mode) against its
    plain version: the same grid indices, float32 rounding of the sums and of
    the ADC gain's division apart (1e-5 relative)."""
    from repro_torch.hwmodel.faults import FaultModel

    fault = FaultModel(**MILD_FAULT) if faulty else None
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randn(5, 49152, device=cuda, generator=g) * 4).to(dtype)
    x[:, :300] = -float("inf")
    before = soft_mod.LUT_LAUNCHES.count
    got = soft_mod.star_softmax_kernel(x, FMT, mode=mode, fault=fault)
    assert soft_mod.LUT_LAUNCHES.count == before + 1
    ref = soft_mod.star_softmax_ref(x, FMT, mode=mode, fault=fault)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_star_softmax_onehot_is_the_gather_kernel_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 49152, device=cuda, generator=g) * 4
    before = soft_mod.LAUNCHES.count
    onehot = soft_mod.star_softmax_kernel(x, FMT, mode="onehot")
    assert soft_mod.LAUNCHES.count == before + 1
    assert torch.equal(onehot, soft_mod.star_softmax_kernel(x, FMT, mode="gather"))


@pytest.mark.cuda
@pytest.mark.parametrize("faulty", [False, True])
def test_crossbar_kernel_matches_plain_on_card(cuda, faulty):
    """Clean: bit-exact (int32 partials are exact).  Faulty float32 weights:
    equal except where an ADC code sits within 1e-3 LSB of a half-step."""
    from repro_torch.hwmodel.faults import FaultModel
    from repro_torch.kernels.crossbar_matmul import kernel as xk
    from repro_torch.kernels.crossbar_matmul import ref as xr

    fault = FaultModel(**MILD_FAULT) if faulty else None
    g = torch.Generator(device=cuda).manual_seed(3)
    for m, k, n in ((7, 300, 190), (64, 512, 384), (130, 1024, 256)):
        x = torch.randn(m, k, device=cuda, generator=g)
        w = torch.randn(k, n, device=cuda, generator=g) * 0.05
        xq, wq, step, off, _ = xr.prepare_operands(x, w, fault=fault)
        got = xk.crossbar_matmul(xq, wq, step, off)
        ref = xr.crossbar_accumulate_ref(xq, wq, step, off)
        if not faulty:
            assert torch.equal(got, ref)
            continue
        differ = got != ref
        assert int(differ.sum()) <= max(1, int(1e-3 * got.numel()))
        if bool(differ.any()):
            kt = xq.shape[1] // 128
            codes = torch.stack([
                (xq.double()[:, i * 128:(i + 1) * 128] @ wq.double()[i * 128:(i + 1) * 128])
                / step[i].double().repeat_interleave(128) for i in range(kt)])
            if off is not None:
                codes = codes + off.double().repeat_interleave(128, dim=1)[:, None, :]
            near = ((codes - codes.floor() - 0.5).abs() < 1e-3).any(dim=0)
            assert not bool((differ & ~near).any())


@pytest.mark.cuda
def test_fault_realization_bits_equal_on_card_and_cpu(cuda):
    from repro_torch.hwmodel import faults as tf

    fault = tf.FaultModel(**MILD_FAULT)
    for fmt_bits in ((6, 2), (6, 3)):
        from repro_torch.core.fixedpoint import FixedPointFormat

        fmt = FixedPointFormat(*fmt_bits)
        for tag in ("softmax/lut", "softmax/vmm"):
            assert torch.equal(tf.faulty_exp_lut(fmt, fault, tag, device=cuda).cpu(),
                               tf.faulty_exp_lut(fmt, fault, tag, device="cpu"))
        assert torch.equal(tf.cam_remap(fmt, fault, device=cuda).cpu(), tf.cam_remap(fmt, fault))
    assert torch.equal(tf.adc_tile_offsets(fault, (32, 112), device=cuda).cpu(),
                       tf.adc_tile_offsets(fault, (32, 112)))
    w = torch.randint(-127, 128, (256, 512), dtype=torch.int32)
    assert torch.equal(tf.apply_cell_faults(w.to(cuda), fault, "matmul/w", g_on=127.0).cpu(),
                       tf.apply_cell_faults(w, fault, "matmul/w", g_on=127.0))
