"""The chunk-parallel SSD scan kernel (``kernels/ssd_scan``).

The CUDA kernel splits the scan into three launches: the chunk state (each
chunk's cumsum of a and its state contribution s), the state pass (the only
sequential step: h <- exp(last) h + s over the chunks) and the chunk output
(y from the scores C B^T, the decay and the state entering the chunk).  Its
products run on the tensor cores as 3xTF32.  Here, with no card:

* a float32 emulation of that decomposition (kept in this file, used by
  nothing else) is held against the plain version (``ssd_scan_ref``, atol
  1e-5: the same float32 function, sums in another order) and against the
  JAX Pallas kernel in interpret mode (the reference test's atol 1e-4), at
  ``tests/test_torch_ssm.py``'s ``SCAN_DIMS`` plus one chunk exactly (nc =
  1, T = chunk);
* the same emulation with its products formed as the kernel forms them
  (3xTF32, tf32 rounding emulated by rounding the mantissa to nearest, ties
  away, as ``cvt.rna``) holds to ``chip_smoke.py``'s SSD_RTOL; with one
  tf32 rounding of each float32 operand it does not;
* the same for one 128 x 128 x 64 product at the serve's magnitudes;
* the wrapper through a fake library: one library call and one count per
  call, B/C pointers and strides passed as they are (no float32 copy), a
  workspace sized from shapes alone, no host read, and shapes whose tiles do
  not fit refused before any library call;
* the source's tile constants match the wrapper's.

``cuda``-marked tests hold the kernel to its plain version on the card (up
to 16 chunks, T = 2000, float32 and bf16 B/C, heads not a multiple of the
head group) and check batch invariance bit for bit (they skip here).
"""

import importlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel as ssd_mod
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.kernel import ssd_scan_pallas as jax_ssd_scan
except ImportError:
    jnp = None

_ssm_tests = importlib.import_module("test_torch_ssm")
_OpLog = importlib.import_module("test_torch_kernels")._OpLog

SCAN_DIMS = _ssm_tests.SCAN_DIMS + [(2, 64, 3, 8, 16, 64)]  # + T equal to one chunk
PLAIN_ATOL = 1e-5
PALLAS_ATOL = 1e-4  # tests/test_kernels_ssd_scan.py's own tolerance


def _ssd_rtol():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SSD_RTOL


SSD_RTOL = _ssd_rtol()


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


def _inputs(b, t, h, p, n, seed=13, bc_dtype=torch.float32, device=None):
    """xdt, a and B / C as strided slices of one [B, T, 2N] tensor, as the
    mixer passes them."""
    rng = np.random.default_rng(seed)
    xdt = torch.as_tensor(rng.normal(size=(b, t, h, p)).astype(np.float32), device=device)
    a = torch.as_tensor(-np.abs(rng.normal(size=(b, t, h)) * 0.1).astype(np.float32),
                        device=device)
    bc = torch.as_tensor((rng.normal(size=(b, t, 2 * n)) * 0.3).astype(np.float32),
                         device=device).to(bc_dtype)
    return xdt, a, bc[..., :n], bc[..., n:]


# ---------------------------------------------------------------------------
# (a) the three-step decomposition, emulated in float32


def _tf32(x):
    """x rounded to the nearest tf32 value, ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _prod(a, b, a_exact, b_exact, products):
    """a @ b in float32 (``products`` None), or as the kernel's tensor-core
    products form it: "3xtf32" splits each float32 operand into tf32 hi and
    lo and sums lo.hi + hi.lo + hi.hi; "tf32" rounds each operand once.  An
    exact operand (a bf16 value) is its own hi."""
    if products is None:
        return a @ b
    ah = a if a_exact else _tf32(a)
    bh = b if b_exact else _tf32(b)
    out = ah @ bh
    if products == "3xtf32":
        if not a_exact:
            out = out + _tf32(a - ah) @ bh
        if not b_exact:
            out = out + ah @ _tf32(b - bh)
    return out


def _emulate(xdt, a, bm, cm, chunk, products=None):
    """The kernel's three launches in float32 on the CPU: chunk state, state
    pass, chunk output.  Rows past T are zeros (the kernel masks them)."""
    b, t, h, p = xdt.shape
    nc = -(-t // chunk)
    pad = nc * chunk - t
    exact = bm.dtype == torch.bfloat16

    def rows(v):  # [B, T, ...] -> [B, nc, Q, ...]
        v = v.float()
        v = torch.cat([v, v.new_zeros((b, pad) + tuple(v.shape[2:]))], 1)
        return v.reshape((b, nc, chunk) + tuple(v.shape[2:]))

    x, av, bq, cq = rows(xdt), rows(a), rows(bm), rows(cm)
    xh = x.permute(0, 1, 3, 2, 4)  # [B, nc, H, Q, P]
    # 1. chunk state: ca, and s = B^T (exp(last - ca) x) per head
    ca = torch.cumsum(av, dim=2).permute(0, 1, 3, 2)  # [B, nc, H, Q]
    last = ca[..., -1]  # [B, nc, H]
    w = torch.exp(last[..., None] - ca)
    s = _prod(bq.transpose(-1, -2)[:, :, None], xh * w[..., None], exact, False, products)
    # 2. state pass: the state entering each chunk, and the final state
    hin = torch.empty_like(s)
    hcur = torch.zeros_like(s[:, 0])
    for c in range(nc):
        hin[:, c] = hcur
        hcur = hcur * torch.exp(last[:, c])[..., None, None] + s[:, c]
    # 3. chunk output: exp(ca_i) C_i h_in + sum_{j<=i} G_ij exp(ca_i - ca_j) x_j
    g = _prod(cq, bq.transpose(-1, -2), exact, exact, products)[:, :, None]  # [B, nc, 1, Q, Q]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    zero = torch.zeros(())
    diff = torch.where(tri, ca[..., :, None] - ca[..., None, :], zero)  # j > i never exponentiated
    sdec = torch.where(tri, g * torch.exp(diff), zero)
    y = _prod(cq[:, :, None], hin, exact, False, products) * torch.exp(ca)[..., None]
    y = y + _prod(sdec, xh, False, False, products)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, h, p)[:, :t]
    return y, hcur


@pytest.mark.parametrize("dims", SCAN_DIMS, ids=lambda d: "x".join(map(str, d)))
def test_chunked_emulation_matches_plain(dims):
    b, t, h, p, n, chunk = dims
    xdt, a, bm, cm = _inputs(b, t, h, p, n)
    y, hout = _emulate(xdt, a, bm, cm, chunk)
    y0, h0 = ssd_scan_ref(xdt, a, bm, cm, chunk=chunk)
    torch.testing.assert_close(y, y0, rtol=0, atol=PLAIN_ATOL)
    torch.testing.assert_close(hout, h0, rtol=0, atol=PLAIN_ATOL)


@pytest.mark.parametrize("dims", SCAN_DIMS, ids=lambda d: "x".join(map(str, d)))
def test_chunked_emulation_matches_pallas(dims, jax_ref):
    b, t, h, p, n, chunk = dims
    xdt, a, bm, cm = _inputs(b, t, h, p, n)
    yj, hj = jax_ssd_scan(*(jnp.asarray(v.numpy()) for v in (xdt, a, bm, cm)), chunk=chunk,
                          interpret=True)
    y, hout = _emulate(xdt, a, bm, cm, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=PALLAS_ATOL)
    np.testing.assert_allclose(hout.numpy(), np.asarray(hj), rtol=0, atol=PALLAS_ATOL)


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", SCAN_DIMS, ids=lambda d: "x".join(map(str, d)))
def test_chunked_emulation_with_3xtf32_products_holds_ssd_rtol(dims, bc_dtype):
    b, t, h, p, n, chunk = dims
    xdt, a, bm, cm = _inputs(b, t, h, p, n, bc_dtype=bc_dtype)
    y, hout = _emulate(xdt, a, bm, cm, chunk, products="3xtf32")
    y0, h0 = ssd_scan_ref(xdt, a, bm, cm, chunk=chunk)
    assert _rel_err(y, y0) <= SSD_RTOL
    assert _rel_err(hout, h0) <= SSD_RTOL


def test_one_tf32_rounding_misses_ssd_rtol():
    """At the mamba2-130m geometry, products from one tf32 rounding of each
    float32 operand miss the plain version by far more than SSD_RTOL."""
    xdt, a, bm, cm = _inputs(2, 128, 24, 64, 128, bc_dtype=torch.bfloat16)
    y, _ = _emulate(xdt, a, bm, cm, 128, products="tf32")
    y0, _ = ssd_scan_ref(xdt, a, bm, cm, chunk=128)
    assert _rel_err(y, y0) > 10 * SSD_RTOL


def _serve_product_operands(seed=21):
    """The intra-chunk product at the serve's magnitudes: decayed causal
    scores S [128, 128] from bf16 B and C (conv outputs ~ N(0, 0.3^2)) and a
    ~ -|N(0, 0.1^2)|, times x [128, 64] ~ N(0, 1); float32, and float64."""
    rng = np.random.default_rng(seed)
    bc = torch.as_tensor(rng.normal(size=(2, 128, 128)) * 0.3, dtype=torch.float32)
    bm, cm = bc.to(torch.bfloat16).float()
    ca = torch.cumsum(torch.as_tensor(-np.abs(rng.normal(size=128) * 0.1), dtype=torch.float32), 0)
    tri = torch.tril(torch.ones(128, 128, dtype=torch.bool))
    decay = torch.exp(torch.where(tri, ca[:, None] - ca[None, :], torch.zeros(())))
    s = torch.where(tri, (cm @ bm.T) * decay, torch.zeros(()))
    x = torch.as_tensor(rng.normal(size=(128, 64)), dtype=torch.float32)
    return s, x, cm


@pytest.mark.parametrize("products, passes", [("3xtf32", True), ("tf32", False)])
def test_split_product_at_serve_magnitudes(products, passes):
    s, x, cm = _serve_product_operands()
    exact = s.double() @ x.double()
    err = float((_prod(s, x, False, False, products).double() - exact).abs().max())
    assert (err <= SSD_RTOL * float(exact.abs().max())) == passes
    # C (bf16, exact in tf32) times a float32 state: two products
    hstate = x * 3.0  # [128, 64]
    exact = cm.double() @ hstate.double()
    err = float((_prod(cm, hstate, True, False, products).double() - exact).abs().max())
    assert (err <= SSD_RTOL * float(exact.abs().max())) == passes


# ---------------------------------------------------------------------------
# (b) the wrapper through a fake library


class _SsdFakeLib:
    def __init__(self):
        self.calls = []

    def ssd_scan_launch(self, *args):
        self.calls.append(args)
        return 0


def _no_host_read(*args, **kwargs):
    raise AssertionError("the ssd_scan wrapper read a value back from the device")


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _SsdFakeLib()
    monkeypatch.setattr(ssd_mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(ssd_mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(ssd_mod._cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(torch.Tensor, "item", _no_host_read)
    monkeypatch.setattr(torch.Tensor, "tolist", _no_host_read)
    monkeypatch.setattr(torch.cuda, "synchronize", _no_host_read)
    return lib


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_wrapper_one_call_with_shape_only_workspace(fake_lib, bc_dtype):
    b, t, h, p, n, chunk = 2, 300, 5, 16, 32, 128
    xdt, a, _, _ = _inputs(b, t, h, p, n)
    conv = torch.zeros((b, t, h * p + 2 * n)).to(bc_dtype)  # the mixer's conv output
    bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    before = ssd_mod.LAUNCHES.count
    with _OpLog() as log:
        y, hout = ssd_mod.ssd_scan(xdt, a, bm, cm, chunk=chunk)
        ssd_mod.ssd_scan(xdt, a, bm, cm, chunk=chunk)
    assert ssd_mod.LAUNCHES.count == before + 2 and len(fake_lib.calls) == 2
    args = fake_lib.calls[0]
    assert args[:6] == (xdt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                        y.data_ptr(), hout.data_ptr())
    assert args[8:17] == (*xdt.stride()[:3], *a.stride()[:2], *bm.stride()[:2], *cm.stride()[:2])
    assert args[17:24] == (b, t, h, p, n, chunk, 1 if bc_dtype == torch.bfloat16 else 0)
    ws_shape, cas_shape = ssd_mod.workspace_shapes(b, t, h, p, n, chunk)
    assert ws_shape == (b, 3, h, n, p) and cas_shape == (b, 3, h, 128)
    made = [shape for _, shapes in log.calls for shape in shapes]
    # per call: y, hout, the workspace (ws, cas); nothing else, so no copy of B/C
    assert made == [(b, t, h, p), (b, h, n, p), ws_shape, cas_shape] * 2
    assert y.dtype == hout.dtype == torch.float32


def test_wrapper_refuses_what_does_not_fit_before_any_library_call(fake_lib):
    xdt, a, bm, cm = _inputs(1, 40, 2, 8, 16)
    before = ssd_mod.LAUNCHES.count
    with pytest.raises(ValueError, match="chunks of at most 128"):
        ssd_mod.ssd_scan(xdt, a, bm, cm, chunk=256)
    big = _inputs(1, 40, 2, 8, 160)
    with pytest.raises(ValueError, match="state of at most 144 rows"):
        ssd_mod.ssd_scan(*big, chunk=16)
    with pytest.raises(ValueError, match="contiguous last dimension of bmat"):
        ssd_mod.ssd_scan(xdt, a, torch.zeros(1, 40, 32)[..., ::2], cm, chunk=16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_mod.ssd_scan(xdt, a, bm.half(), cm.half(), chunk=16)
    assert fake_lib.calls == [] and ssd_mod.LAUNCHES.count == before


def test_tile_constants_match_the_source():
    src = ssd_mod.SOURCE.read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("QPAD")) == ssd_mod.QPAD
    assert int(const("MAX_STATE")) == ssd_mod.MAX_STATE
    warps = int(const("NTHREADS")) // 32
    assert const("MAX_CHUNK") == "16 * NWARPS" and 16 * warps == ssd_mod.MAX_CHUNK
    # the source proves at compile time that these limits fit shared memory
    assert "static_assert(scan_smem_bytes(MAX_CHUNK, MAX_STATE) <= SMEM_LIMIT" in src
    for name in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_scan_kernel"):
        assert f" {name}(Params p)" in src


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version, and batch invariance

CARD_DIMS = [
    # b, t, h, p, n, chunk
    (2, 2048, 4, 64, 128, 128),  # 16 chunks
    (3, 2000, 7, 64, 128, 128),  # ragged tail; 7 heads in groups of 3 and of 4
    (2, 300, 5, 96, 64, 100),  # two head-dim slices, a chunk padded to 128 rows
    (1, 70, 5, 6, 24, 48),  # unaligned rows: scalar loads
    (2, 257, 6, 64, 144, 128),  # the largest state that fits
    (1, 0, 2, 8, 16, 16),  # no steps: a zero state
] + _ssm_tests.SCAN_DIMS


@pytest.mark.cuda
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunked_kernel_matches_plain_on_card(cuda, bc_dtype):
    """y and the final state within SSD_RTOL of their largest magnitude."""
    for b, t, h, p, n, chunk in CARD_DIMS:
        xdt, a, bm, cm = _inputs(b, t, h, p, n, bc_dtype=bc_dtype, device=cuda)
        before = ssd_mod.LAUNCHES.count
        y, hout = ssd_mod.ssd_scan(xdt, a, bm, cm, chunk=chunk)
        assert ssd_mod.LAUNCHES.count == before + 1
        y0, h0 = ssd_scan_ref(xdt, a, bm, cm, chunk=chunk)
        for got, ref in ((y, y0), (hout, h0)):
            assert bool(torch.isfinite(got).all())
            scale = float(ref.abs().max()) if ref.numel() else 0.0
            torch.testing.assert_close(got, ref, rtol=0, atol=SSD_RTOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunked_kernel_is_batch_invariant_on_card(cuda, bc_dtype):
    """Row 3 of a batch of 8 gives the same bits alone (where the chunk-scan
    kernel groups the heads otherwise)."""
    xdt, a, bm, cm = _inputs(8, 1000, 24, 64, 128, bc_dtype=bc_dtype, device=cuda)
    y, hout = ssd_mod.ssd_scan(xdt, a, bm, cm, chunk=128)
    y1, h1 = ssd_mod.ssd_scan(xdt[3:4], a[3:4], bm[3:4], cm[3:4], chunk=128)
    assert torch.equal(y1[0], y[3]) and torch.equal(h1[0], hout[3])
