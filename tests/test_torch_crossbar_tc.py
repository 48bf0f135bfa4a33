"""The crossbar MatMul kernel on the tensor cores, its arithmetic and its
bookkeeping checked here without a card, and on the card against its plain
version (marked ``cuda``).

* the three-piece bf16 split of faulty weights (``hi = bf16(w)``, ``mid =
  bf16(w - hi)``, ``lo = bf16(w - hi - mid)``, ``flash_star.ref.split_bf16x3``)
  is exact on every code -127..127 scaled by the fault's factors, on
  stuck-on, stuck-off and zero cells and on random float32 values;
* the staging and fragment index maps of ``csrc/crossbar_matmul.cu``
  mirrored in numpy: the int8 w tile transposed through ``__byte_perm``, the
  s8 A / B and the bf16 A / B.trans fragments that ``ldmatrix`` hands each
  lane, decoded back to the x and w blocks of the ``[K, N]`` layout, and the
  int8 codes' exact bf16 conversion;
* a float32 emulation of the kernel's tile loop (clean: int32 partials;
  faulty: the three pieces' 16-term sums then one IEEE add per 16 k)
  against the plain version and the JAX Pallas kernel in interpret mode:
  clean bit-exact, faulty flipping only ADC codes within ``FLIP_DELTA`` of
  a half-step, on at most ``FLIP_BOUND`` of the outputs (``chip_smoke.py``'s
  constants);
* the wrapper's routing and its 16-byte check through a fake library.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.kernels.crossbar_matmul.kernel import crossbar_matmul_pallas as jax_crossbar
except ImportError:
    jnp = None

from repro_torch.hwmodel import faults as tf
from repro_torch.kernels.flash_star.ref import split_bf16x3

xk = importlib.import_module("repro_torch.kernels.crossbar_matmul.kernel")
xr = importlib.import_module("repro_torch.kernels.crossbar_matmul.ref")

SOURCE = Path(xk.__file__).parent / "csrc" / "crossbar_matmul.cu"
TILE, BM = 128, 128    # crossbar tile, CTA rows
KS_CLEAN = TILE        # k per staged stage: a whole tile when clean,
KS_FAULTY = 64         # half a tile under a fault
XP = WT_P = KS_CLEAN + 16  # clean: int8 x stage and transposed w pitches (bytes)
XB_P = KS_FAULTY + 8   # faulty: x as bf16 (elements)
FLIP_DELTA = 1e-3      # chip_smoke.py: ADC LSBs from a half-step
FLIP_BOUND = 1e-4      # chip_smoke.py: flipped outputs per output
MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
            adc_offset_sigma=0.1, read_disturb=0.01, seed=7)
SEVERE = dict(stuck_on_rate=0.6, stuck_off_rate=0.2, seed=3)


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


def _pieces_sum(w):
    hi, mid, lo = split_bf16x3(torch.as_tensor(w, dtype=torch.float32))
    return hi.double() + mid.double() + lo.double()


# ---------------------------------------------------------------------------
# the three-piece split of faulty weights


@pytest.mark.parametrize("fault", [MILD, SEVERE, dict(g_sigma=0.3, read_disturb=0.05, seed=2)],
                         ids=["mild", "severe", "variation"])
def test_split_is_exact_on_every_faulty_code(fault):
    """Every code -127..127 in every column, through the fault's factors and
    stuck cells: the three pieces sum to the float32 weight exactly."""
    codes = torch.arange(-127, 128, dtype=torch.int32)[:, None].repeat(1, 384)
    w = xr.apply_weight_faults(codes, xr.DEFAULT_SPEC, tf.FaultModel(**fault))
    assert w.dtype == torch.float32
    assert bool((w == 0.0).any())  # the zero code, and stuck-off cells
    if fault.get("stuck_on_rate"):
        assert bool((w == 127.0).any())
    assert torch.equal(_pieces_sum(w), w.double())


def test_split_is_exact_on_random_float32():
    rng = np.random.default_rng(21)
    w = np.concatenate([
        rng.normal(size=4096) * 40, rng.normal(size=4096) * 1e-20,
        rng.choice([-1, 1], 4096) * rng.uniform(1, 2, 4096)
        * 2.0 ** rng.integers(-100, 100, 4096),
        [0.0, -0.0, 127.0, -127.0, 2.0 ** -100, 1e30],
    ]).astype(np.float32)
    assert torch.equal(_pieces_sum(w), torch.as_tensor(w).double())


def test_split_pieces_hold_eight_bits_each():
    """hi carries the top 8 significant bits, mid the next 8, lo the last 8:
    each piece is at most half an ulp of the one before."""
    w = torch.as_tensor(np.random.default_rng(22).normal(size=8192) * 50, dtype=torch.float32)
    hi, mid, lo = (p.double() for p in split_bf16x3(w))
    nz = hi != 0
    assert bool((mid.abs()[nz] <= hi.abs()[nz] * 2.0 ** -8).all())
    nz = mid != 0
    assert bool((lo.abs()[nz] <= mid.abs()[nz] * 2.0 ** -8).all())


# ---------------------------------------------------------------------------
# the kernel's staging and fragment maps, mirrored


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm`` on uint32 arrays."""
    src = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)] +
                   [(y >> (8 * i)) & 0xFF for i in range(4)]).astype(np.uint32)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        out |= src[(s >> (4 * i)) & 0x7] << np.uint32(8 * i)
    return out


def ldsm_x4(smem, addrs, trans=False):
    """``ldmatrix.x4`` (b16) on a byte array: lane ``l`` gives the address
    of row ``l % 8`` of matrix ``l // 8``; returns regs ``[4][32]`` uint32."""
    regs = np.zeros((4, 32), np.uint32)
    for i in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            if not trans:
                a = addrs[8 * i + g] + 4 * t
                regs[i, lane] = int.from_bytes(bytes(smem[a:a + 4]), "little")
            else:
                lo = addrs[8 * i + 2 * t] + 2 * g
                hi = addrs[8 * i + 2 * t + 1] + 2 * g
                regs[i, lane] = (int.from_bytes(bytes(smem[lo:lo + 2]), "little")
                                 | int.from_bytes(bytes(smem[hi:hi + 2]), "little") << 16)
    return regs


def transpose_w_tile(wraw, bn):
    """The clean prep pass: ``wraw`` uint8 ``[KS_CLEAN, bn]`` -> ``wT``
    bytes ``[bn][WT_P]`` through 4 k x 4 n blocks, as the kernel does."""
    wr = wraw.reshape(KS_CLEAN, bn // 4, 4).view(np.uint32).reshape(KS_CLEAN, bn // 4)
    wt = np.zeros(bn * WT_P, np.uint8)
    for e in range((KS_CLEAN // 4) * (bn // 4)):
        nb, kb = e % (bn // 4), e // (bn // 4)
        r = [np.uint32(wr[4 * kb + i, nb]) for i in range(4)]
        t0, t1 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[2], r[3], 0x5140)
        t2, t3 = byte_perm(r[0], r[1], 0x7362), byte_perm(r[2], r[3], 0x7362)
        cols = [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
                byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]
        for j, word in enumerate(cols):
            o = (4 * nb + j) * WT_P + 4 * kb
            wt[o:o + 4] = np.frombuffer(int(word).to_bytes(4, "little"), np.uint8)
    return wt


def _s8(u):
    return np.array([(u >> (8 * i)) & 0xFF for i in range(4)], np.uint8).view(np.int8)


def _bf16x2(u):
    return (np.array([u & 0xFFFF, u >> 16], np.uint32) << 16).view(np.float32)


def s8x2_to_bf16x2(u, i):
    """The kernel's exact int8 -> bf16 pair: 1.5 * 2^23 + v has ulp 1."""
    vals = []
    for b in (2 * i, 2 * i + 1):
        v = int(np.int8(np.uint8((u >> (8 * b)) & 0xFF)))
        magic = np.array([0x4B400000 + v], np.int32).view(np.float32)[0]
        f = np.float32(magic - np.float32(12582912.0))
        vals.append(int(np.array([f], np.float32).view(np.uint32)[0]))
    return int(byte_perm(np.uint32(vals[0]), np.uint32(vals[1]), 0x7632))


def test_int8_codes_convert_to_bf16_exactly():
    for v0 in range(-128, 128, 3):
        for v1 in (-128, -127, -1, 0, 1, 127, v0 // 2):
            u = (v0 & 0xFF) | (v1 & 0xFF) << 8 | (5 << 16) | (0xFB << 24)
            assert list(_bf16x2(s8x2_to_bf16x2(u, 0))) == [v0, v1]
            assert list(_bf16x2(s8x2_to_bf16x2(u, 1))) == [5, -5]


@pytest.mark.parametrize("bn", [32, 64])
def test_clean_fragments_decode_to_the_kn_layout(bn):
    """A clean stage (a whole tile): x staged as it lands ([128][XP] bytes),
    w transposed to [bn][WT_P]: every warp's s8 A and B fragments for every
    k32 step are the x and w blocks of the ``[M, K] @ [K, N]`` layout."""
    rng = np.random.default_rng(23)
    x = rng.integers(-127, 128, (BM, KS_CLEAN)).astype(np.int8)
    w = rng.integers(-127, 128, (KS_CLEAN, bn)).astype(np.int8)
    xs = np.zeros(BM * XP, np.uint8)
    for r in range(BM):
        xs[r * XP:r * XP + KS_CLEAN] = x[r].view(np.uint8)
    wt = transpose_w_tile(w.view(np.uint8), bn)
    for n in range(bn):
        assert np.array_equal(wt[n * WT_P:n * WT_P + KS_CLEAN].view(np.int8), w[:, n])
    for warp in range(4 * bn // 32):
        wm, wn = warp % 4, warp // 4
        for ks in range(KS_CLEAN // 32):
            for mi in range(2):
                addrs = [(wm * 32 + mi * 16 + ln % 8 + ((ln // 8) & 1) * 8) * XP + ks * 32
                         + (ln // 16) * 16 for ln in range(32)]
                a = ldsm_x4(xs, addrs)
                blk = np.zeros((16, 32), np.int8)
                for ln in range(32):
                    g, t = ln // 4, ln % 4
                    blk[g, 4 * t:4 * t + 4] = _s8(a[0, ln])
                    blk[g + 8, 4 * t:4 * t + 4] = _s8(a[1, ln])
                    blk[g, 16 + 4 * t:20 + 4 * t] = _s8(a[2, ln])
                    blk[g + 8, 16 + 4 * t:20 + 4 * t] = _s8(a[3, ln])
                r0 = wm * 32 + mi * 16
                assert np.array_equal(blk, x[r0:r0 + 16, ks * 32:ks * 32 + 32])
            for np_ in range(2):
                addrs = [(wn * 32 + np_ * 16 + ln % 8 + (ln // 16) * 8) * WT_P + ks * 32
                         + ((ln // 8) & 1) * 16 for ln in range(32)]
                b = ldsm_x4(wt, addrs)
                for half in range(2):  # n8 blocks 2 np and 2 np + 1
                    blk = np.zeros((32, 8), np.int8)
                    for ln in range(32):
                        g, t = ln // 4, ln % 4
                        blk[4 * t:4 * t + 4, g] = _s8(b[2 * half, ln])
                        blk[16 + 4 * t:20 + 4 * t, g] = _s8(b[2 * half + 1, ln])
                    c0 = wn * 32 + (2 * np_ + half) * 8
                    assert np.array_equal(blk, w[ks * 32:ks * 32 + 32, c0:c0 + 8])


@pytest.mark.parametrize("bn", [32, 64])
def test_faulty_fragments_decode_to_the_kn_layout(bn):
    """A faulty stage (64 k): x codes converted to a bf16 plane [128][XB_P] and
    the hi piece of w in a [64][bn + 8] plane: every warp's bf16 A
    fragments and B.trans fragments for every k16 step are the x and w
    blocks."""
    rng = np.random.default_rng(24)
    pl_p = bn + 8
    x = rng.integers(-127, 128, (BM, KS_FAULTY)).astype(np.int8)
    w = (rng.normal(size=(KS_FAULTY, bn)) * 30).astype(np.float32)
    hi = split_bf16x3(torch.as_tensor(w))[0].float().numpy()
    xb = np.zeros(BM * XB_P * 2, np.uint8)
    for r in range(BM):
        words = x[r].view(np.uint8).view(np.uint32)
        packed = [s8x2_to_bf16x2(int(u), i) for u in words for i in range(2)]
        xb[r * XB_P * 2:r * XB_P * 2 + 2 * KS_FAULTY] = np.array(packed, np.uint32).view(np.uint8)
    plane = np.zeros(KS_FAULTY * pl_p * 2, np.uint8)
    for k in range(KS_FAULTY):
        bits = (hi[k].view(np.uint32) >> 16).astype(np.uint16)
        plane[k * pl_p * 2:k * pl_p * 2 + 2 * bn] = bits.view(np.uint8)
    for warp in range(4 * bn // 32):
        wm, wn = warp % 4, warp // 4
        for ks in range(KS_FAULTY // 16):
            for mi in range(2):
                addrs = [2 * ((wm * 32 + mi * 16 + ln % 8 + ((ln // 8) & 1) * 8) * XB_P
                              + ks * 16 + (ln // 16) * 8) for ln in range(32)]
                a = ldsm_x4(xb, addrs)
                blk = np.zeros((16, 16), np.float32)
                for ln in range(32):
                    g, t = ln // 4, ln % 4
                    blk[g, 2 * t:2 * t + 2] = _bf16x2(a[0, ln])
                    blk[g + 8, 2 * t:2 * t + 2] = _bf16x2(a[1, ln])
                    blk[g, 8 + 2 * t:10 + 2 * t] = _bf16x2(a[2, ln])
                    blk[g + 8, 8 + 2 * t:10 + 2 * t] = _bf16x2(a[3, ln])
                r0 = wm * 32 + mi * 16
                assert np.array_equal(blk, x[r0:r0 + 16, ks * 16:ks * 16 + 16].astype(np.float32))
            for np_ in range(2):
                addrs = [2 * ((ks * 16 + ln % 8 + ((ln // 8) & 1) * 8) * pl_p + wn * 32
                              + np_ * 16 + (ln // 16) * 8) for ln in range(32)]
                b = ldsm_x4(plane, addrs, trans=True)
                for half in range(2):
                    blk = np.zeros((16, 8), np.float32)
                    for ln in range(32):
                        g, t = ln // 4, ln % 4
                        blk[2 * t:2 * t + 2, g] = _bf16x2(b[2 * half, ln])
                        blk[8 + 2 * t:10 + 2 * t, g] = _bf16x2(b[2 * half + 1, ln])
                    c0 = wn * 32 + (2 * np_ + half) * 8
                    assert np.array_equal(blk, hi[ks * 16:ks * 16 + 16, c0:c0 + 8])


def test_tile_constants_match_the_source():
    src = SOURCE.read_text()
    assert "constexpr int TILE = 128;" in src and "constexpr int BM = 128;" in src
    assert f"static constexpr int KS = FAULTY ? {KS_FAULTY} : TILE;" in src
    assert "static constexpr int XP = KS + 16;" in src
    assert "static constexpr int WT_P = KS + 16;" in src
    assert "static constexpr int XB_P = KS + 8;" in src
    assert "static constexpr int PL_P = BN + 8;" in src
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "__fdiv_rn(part, st)" in src and "rintf(code)" in src
    assert re.search(r"ctas64 >= sms\s*\?\s*launch_tc<FAULTY, 64, ADC>", src)


# ---------------------------------------------------------------------------
# the tile loop, emulated in float32


def emulate_tiles(xq, wq, step, off=None, adc_levels=15):
    """The kernel's arithmetic on CPU tensors: per K tile, clean int8 codes
    as an exact int partial; faulty float32 weights in three bf16 pieces,
    each 16 k's three products summed (one float32 rounding) and added to
    the partial with one float32 add; then the ADC step in float32."""
    m, k = xq.shape
    n = wq.shape[1]
    kt, nt = k // TILE, n // TILE
    faulty = wq.is_floating_point()
    xd = xq.double()
    if faulty:
        pieces = [p.double() for p in split_bf16x3(wq)]
    acc = torch.zeros((m, n), dtype=torch.float32)
    stf = step.float().repeat_interleave(TILE, dim=1)
    for t in range(kt):
        rows = slice(t * TILE, (t + 1) * TILE)
        if faulty:
            part = torch.zeros((m, n), dtype=torch.float32)
            for k16 in range(TILE // 16):
                ks = slice(t * TILE + k16 * 16, t * TILE + k16 * 16 + 16)
                d = sum(xd[:, ks] @ p[ks] for p in pieces)
                part = part + d.float()
        else:
            part = (xq[:, rows].long() @ wq[rows].long()).float()
        code = part / stf[t]
        if off is not None:
            code = code + off[t].repeat_interleave(TILE)
        q = torch.clamp(torch.round(code), -adc_levels, adc_levels)
        acc = acc + q * stf[t]
    return acc


def _half_step_codes(xq, wq, step, off):
    """Per output, whether any K tile's ADC code sits within FLIP_DELTA of a
    half-step (from float64 partials)."""
    kt = xq.shape[1] // TILE
    near = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.bool, device=xq.device)
    for i in range(kt):
        code = (xq.double()[:, i * TILE:(i + 1) * TILE] @ wq.double()[i * TILE:(i + 1) * TILE]) \
            / step[i].double().repeat_interleave(TILE)
        if off is not None:
            code = code + off[i].double().repeat_interleave(TILE)
        near |= (code - code.floor() - 0.5).abs() < FLIP_DELTA
    return near


def _operands(seed, m, k, n, fault):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g)
    w = torch.randn(k, n, generator=g) * 0.05
    f = tf.FaultModel(**fault) if fault else None
    return xr.prepare_operands(x, w, fault=f)


@pytest.mark.parametrize("mkn", [(7, 300, 190), (64, 512, 384), (130, 1024, 256)])
def test_clean_emulation_is_the_plain_version(mkn):
    xq, wq, step, off, _ = _operands(31, *mkn, None)
    got = emulate_tiles(xq, wq, step, off)
    assert torch.equal(got, xr.crossbar_accumulate_ref(xq, wq, step, off))


@pytest.mark.parametrize("fault", [MILD, SEVERE], ids=["mild", "severe"])
@pytest.mark.parametrize("mkn", [(7, 300, 190), (64, 512, 384), (130, 1024, 256)])
def test_faulty_emulation_flips_only_at_half_steps(mkn, fault):
    xq, wq, step, off, _ = _operands(32, *mkn, fault)
    got = emulate_tiles(xq, wq, step, off)
    ref = xr.crossbar_accumulate_ref(xq, wq, step, off)
    differ = got != ref
    assert not bool((differ & ~_half_step_codes(xq, wq, step, off)).any())
    assert int(differ.sum()) <= max(1, FLIP_BOUND * got.numel())


@pytest.mark.parametrize("faulty", [False, True])
def test_emulation_matches_the_pallas_kernel(faulty, jax_ref):
    xq, wq, step, off, _ = _operands(33, 48, 384, 256, MILD if faulty else None)
    got = emulate_tiles(xq, wq, step, off)
    jx = jnp.asarray(xq.to(torch.int8).numpy())
    jw = jnp.asarray(wq.numpy() if faulty else wq.to(torch.int8).numpy())
    ref = np.asarray(jax_crossbar(jx, jw, jnp.asarray(step.numpy()),
                                  None if off is None else jnp.asarray(off.numpy()),
                                  interpret=True))
    # the Pallas kernel's interpret-mode jit fuses the ADC multiply and the
    # accumulate: a few ulps of the running sum's largest magnitude
    np.testing.assert_allclose(got.numpy(), ref, atol=4 * np.spacing(np.abs(ref).max()), rtol=0)


# ---------------------------------------------------------------------------
# the wrapper, through a fake library


class _FakeLib:
    def __init__(self):
        self.calls = []

    def crossbar_matmul_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("bits,faulty,types", [(8, False, (0, 0)), (8, True, (0, 2)),
                                               (12, False, (1, 1)), (12, True, (1, 2))])
def test_wrapper_routes_types_and_counts_one_launch(bits, faulty, types, monkeypatch):
    spec = xr.CrossbarSpec(weight_bits=bits, input_bits=bits)
    g = torch.Generator().manual_seed(34)
    xq, wq, step, off, _ = xr.prepare_operands(
        torch.randn(5, 256, generator=g), torch.randn(256, 384, generator=g), spec,
        fault=tf.FaultModel(**MILD) if faulty else None)
    lib = _FakeLib()
    monkeypatch.setattr(xk._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(xk._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(xk._cuda, "stream_handle", lambda device: 0)
    before = xk.LAUNCHES.count
    out = xk.crossbar_matmul(xq, wq, step, off, spec=spec)
    assert xk.LAUNCHES.count == before + 1 and len(lib.calls) == 1
    args = lib.calls[0]
    assert out.shape == (5, 384) and out.dtype == torch.float32
    assert args[5:8] == (5, 256, 384) and args[8:10] == types
    assert args[10] == spec.adc_levels and (args[3] is None) == (off is None)


def test_wrapper_refuses_a_misaligned_operand(monkeypatch):
    g = torch.Generator().manual_seed(35)
    xq, wq, step, _, _ = xr.prepare_operands(torch.randn(4, 128, generator=g),
                                             torch.randn(128, 128, generator=g))
    lib = _FakeLib()
    monkeypatch.setattr(xk._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(xk._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(xk._cuda, "stream_handle", lambda device: 0)
    flat = torch.zeros(4 * 128 + 1, dtype=torch.int8)
    shifted = flat[1:].view(4, 128)
    shifted.copy_(xq.to(torch.int8))
    before = xk.LAUNCHES.count
    with pytest.raises(ValueError, match="16-byte aligned xq"):
        xk.crossbar_matmul(shifted, wq, step)
    assert xk.LAUNCHES.count == before and not lib.calls


# ---------------------------------------------------------------------------
# on the card


CARD_SHAPES = [(m, 512, n) for m in (1, 65, 256, 300) for n in (128, 4096)]
PHASE7_SHAPES = [(256, 4096, 4096), (256, 4096, 14336)]


def _card_check(got, ref, xq, wq, step, off, faulty):
    if not faulty:
        assert torch.equal(got, ref)
        return
    differ = got != ref
    assert int(differ.sum()) <= max(1, int(FLIP_BOUND * got.numel()))
    if bool(differ.any()):
        assert not bool((differ & ~_half_step_codes(xq, wq, step, off)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("mkn", CARD_SHAPES + PHASE7_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_crossbar_tc_kernel_matches_plain_on_card(cuda, mkn, faulty):
    """Clean: bit-exact.  Faulty: outputs differ only where an ADC code is
    within FLIP_DELTA of a half-step, on at most FLIP_BOUND of them."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(36)
    x = torch.randn(m, k, device=cuda, generator=g)
    w = torch.randn(k, n, device=cuda, generator=g) * 0.05
    xq, wq, step, off, _ = xr.prepare_operands(
        x, w, fault=tf.FaultModel(**MILD) if faulty else None)
    before = xk.LAUNCHES.count
    got = xk.crossbar_matmul(xq, wq, step, off)
    assert xk.LAUNCHES.count == before + 1
    ref = xr.crossbar_accumulate_ref(xq, wq, step, off)
    _card_check(got, ref, xq, wq, step, off, faulty)
