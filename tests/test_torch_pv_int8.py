"""flash_star's int8 P.V variant: the port's plain version against the JAX
``flash_star_attention(..., pv_int8=True)`` in interpret mode, on the same
inputs; the capability rows that keep it off the other attention impls; and
(marked ``cuda``, skipped where there is no card) the CUDA variant against
its plain version.

q and k are multiples of 1/8, so every score is exact in float32 whatever
the summation order and no score snaps to another grid level between two
implementations.  Rows past ``kv_valid`` hold the largest V values, so the
block absmax (and with it every V code) is wrong unless those rows count.

Tolerance: the int8 codes are equal; what remains is float32 rounding of
the denominator and accumulator sums (whose order differs, and which the
reference's interpret-mode jit may contract into FMAs): atol 1e-6, eight
float32 ulps at 1.0, against outputs of magnitude up to ~2.  One int8 code
flip moves an output by at least vamax / 127^2 / denominator, about 1e-5
at these sizes, so a flip cannot hide under it.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.ops.registry import CapabilityError

try:  # the machine with the card runs the ``cuda`` test without JAX
    import jax.numpy as jnp

    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
except ImportError:
    jnp = None

flash_mod = importlib.import_module("repro_torch.kernels.flash_star.kernel")

ATOL = 1e-6

CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid, block_k
    (1, 4, 2, 13, 29, True, None, 16, None, 16),      # Tk % block_k != 0: zero pad rows
    (2, 4, 2, 9, 29, True, None, 20, (29, 17), 16),   # ragged, q_offset
    (2, 4, 2, 19, 40, False, None, 0, (40, 6), 32),   # ragged, non-causal, block_k 32
    (1, 4, 4, 24, 24, True, 7, 0, None, 16),          # sliding window
    (1, 4, 2, 40, 70, True, None, 30, (70,), 32),     # q_offset, several blocks
]


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


def _operands(case, seed=21, d=16, amplify=True):
    b, hq, hkv, tq, tk, causal, window, q_off, kvl, bk = case
    rng = np.random.default_rng(seed)
    q = (rng.integers(-16, 17, (b, hq, tq, d)) / 8.0).astype(np.float32)
    k = (rng.integers(-16, 17, (b, hkv, tk, d)) / 8.0).astype(np.float32)
    v = rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
    valid = list(kvl or [tk] * b)
    for i, n in enumerate(valid):
        if amplify:
            v[i, :, n:] *= 4.0  # the block absmax sits past kv_valid
    info = np.array([q_off] + valid, np.int32)
    kw = dict(causal=causal, sliding_window=window, block_k=bk)
    return q, k, v, info, kw


@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"tq{c[3]}_tk{c[4]}_bk{c[9]}")
def test_pv_int8_plain_matches_pallas(case, star, jax_ref):
    q, k, v, info, kw = _operands(case)
    ref = np.asarray(jax_flash(
        *map(jnp.asarray, (q, k, v, info)), fmt=JFMT if star else None,
        block_q=16, pv_int8=True, interpret=True, **kw))
    got = flash_mod.flash_star_attention(
        *map(torch.as_tensor, (q, k, v, info)), fmt=FMT if star else None, pv_int8=True, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_pv_int8_v_codes_round_ties_like_the_reference(star, jax_ref):
    """V codes at rounding ties: with a block absmax of 1.875, v = 0.9375
    puts v * 127 / vamax at 63.5.  ``127 / vamax`` rounded as IEEE division
    rounds it to code 63; ``(1 / vamax) * 127`` lands above the tie and gives
    64.  The plain version divides as the reference does."""
    q, k, _, info, kw = _operands(CASES[0])
    rng = np.random.default_rng(22)
    v = rng.choice(np.array([-1.875, -0.9375, 0.9375, 1.875, 0.25], np.float32),
                   size=(1, 2, 29, 16))
    ref = np.asarray(jax_flash(
        *map(jnp.asarray, (q, k, v, info)), fmt=JFMT if star else None,
        block_q=16, pv_int8=True, interpret=True, **kw))
    got = flash_mod.flash_star_attention(
        *map(torch.as_tensor, (q, k, v, info)), fmt=FMT if star else None, pv_int8=True, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"tq{c[3]}_tk{c[4]}_bk{c[9]}")
def test_pv_int8_close_to_float_pv(case, star):
    """The reference's own check (``test_pv_int8_close_to_f32``): on inputs
    of one scale the int8 P.V stays within 0.05 of the float P.V."""
    *arrays, kw = _operands(case, amplify=False)
    q, k, v, info = map(torch.as_tensor, arrays)
    fmt = FMT if star else None
    out8 = flash_mod.flash_star_attention(q, k, v, info, fmt=fmt, pv_int8=True, **kw)
    full = flash_mod.flash_star_attention(q, k, v, info, fmt=fmt, **kw)
    assert float((out8 - full).abs().max()) < 0.05


@pytest.mark.parametrize("impl", ["reference", "xla"])
def test_pv_int8_refused_outside_pallas(impl):
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(CapabilityError, match="pv_int8"):
        ops.attention(q, q, q, ops.AttentionSpec(impl=impl, pv_int8=True))
    out = ops.attention(q, q, q, ops.AttentionSpec(impl="pallas", pv_int8=True))
    assert out.shape == q.shape


def test_pv_int8_kernel_refuses_blocks_above_its_tile(monkeypatch):
    """On the card the variant takes KV blocks of any size (the name
    predates it: it refused blocks above 128 rows): block_k 256 over Tk 300
    reaches the pre-pass and the attention launch with bk 256, and block_k
    1000 with bk = Tk; a block_k of 0 is refused before any launch (the
    library calls are a fake here, where there is no card)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(flash_mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(flash_mod._cuda, "load", lambda source, bind: Lib())
    monkeypatch.setattr(flash_mod._cuda, "stream_handle", lambda device: 0)
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 2, 300, 16)
    info = torch.tensor([0, 300], dtype=torch.int32)
    for block_k, bk in ((256, 256), (1000, 300)):
        calls.clear()
        flash_mod.flash_star_attention(q, k, k, info, fmt=FMT, block_k=block_k, pv_int8=True)
        assert [name for name, _ in calls] == ["flash_star_quantize_v_launch",
                                               "flash_star_pv_int8_launch"]
        assert calls[0][1][9] == bk and calls[1][1][30] == bk
    calls.clear()
    with pytest.raises(ValueError, match="block_k must be > 0"):
        flash_mod.flash_star_attention(q, k, k, info, fmt=FMT, block_k=0, pv_int8=True)
    assert calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_pv_int8_kernel_matches_plain_on_card(cuda, dtype, star):
    """The same codes on the card: outputs within float32 rounding of the
    sums (bf16 outputs: two bf16 ulps)."""
    tol = dict(atol=8e-3, rtol=8e-3) if dtype == torch.bfloat16 else dict(atol=1e-5, rtol=1e-5)
    for case in CASES + [(1, 8, 2, 130, 300, True, None, 170, (260,), 128)]:
        for d in (16, 128):
            q, k, v, info, kw = _operands(case, d=d)
            q, k, v = (torch.as_tensor(x, device=cuda).to(dtype) for x in (q, k, v))
            info = torch.as_tensor(info, device=cuda)
            fmt = FMT if star else None
            before = flash_mod.PV_INT8_LAUNCHES.count
            got = flash_mod.flash_star_attention(q, k, v, info, fmt=fmt, pv_int8=True, **kw)
            assert flash_mod.PV_INT8_LAUNCHES.count == before + 1
            ref = flash_mod.flash_star_ref(q, k, v, info, fmt=fmt, pv_int8=True, **kw)
            torch.testing.assert_close(got.float(), ref.float(), **tol)
