"""The STAR row softmax as one split-row kernel on a thread-block cluster
(``kernels/star_softmax/csrc/star_softmax_lut.cu``), checked here without a
card and on the card against its plain version (marked ``cuda``).

* the cluster size the wrapper picks from the row length ``d``, and the
  slices it hands each CTA (16-byte aligned, none empty, within the
  registers the kernel keeps up to 8 x 8192 columns);
* a float32 emulation of the cluster's reductions (the integer row max of
  the C slices; per-rank partial sums added in rank order; integer counts
  summed across ranks, then the VMM dot) against ``star_softmax_ref`` and
  the JAX package (the reference engine, and the Pallas kernel in
  interpret mode), within the card test's tolerance (rtol 1e-5, atol 1e-9);
* the wrapper through a fake library: every mode, clean or faulty, is one
  launch of the one kernel, counted as ``star_softmax`` (clean gather /
  onehot) or ``star_softmax_lut`` (histogram, faults).
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax.numpy as jnp

    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.star_softmax.kernel import star_softmax_pallas as jax_star

    jax_core_softmax = importlib.import_module("repro.core.star_softmax")
except ImportError:
    jnp = None

from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.core.fixedpoint import quantize_logits
from repro_torch.hwmodel import faults as tf

sk = importlib.import_module("repro_torch.kernels.star_softmax.kernel")
SOURCE = sk.LUT_SOURCE
NT, EPT = 256, 32  # the kernel's threads a CTA and snapped values a thread keeps
MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
            adc_offset_sigma=0.1, read_disturb=0.01, seed=7)
MODES = ("gather", "onehot", "histogram")


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("needs JAX (the reference)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# cluster size and slices


@pytest.mark.parametrize("d,cluster", [(1, 1), (17, 1), (4096, 1), (4097, 2), (49152, 8),
                                       (50688, 8), (2 ** 20, 8)])
def test_cluster_size_and_slices(d, cluster):
    assert sk.cluster_size(d) == cluster
    s = sk.slice_len(d, cluster)
    assert s % sk.SLICE_ALIGN == 0 and s >= 1
    assert cluster * s >= d and (cluster - 1) * s < d  # every column, no empty slice
    if d <= sk.CLUSTER_MAX * NT * EPT:
        assert s <= NT * EPT  # the slice stays in registers: x is read once
    else:
        assert s > NT * EPT  # the kernel walks it in rounds


def test_cluster_size_never_leaves_a_slice_empty():
    for d in list(range(1, 600)) + list(range(4000, 70000, 97)) + [2 ** 20 + 1]:
        c = sk.cluster_size(d)
        s = sk.slice_len(d, c)
        assert 1 <= c <= sk.CLUSTER_MAX and c * s >= d and (c - 1) * s < d


def test_kernel_constants_match_the_source():
    src = SOURCE.read_text()
    assert f"constexpr int NT = {NT};" in src and f"constexpr int EPT = {EPT};" in src
    assert f"cluster > {sk.CLUSTER_MAX}" in src and f"slice % {sk.SLICE_ALIGN} != 0" in src
    assert "cudaLaunchAttributeClusterDimension" in src and "map_shared_rank" in src
    assert re.search(r"__fdiv_rn\(s_lut\[s_remap\[", src)
    assert not list(SOURCE.parent.parent.glob("triton_kernel.py"))


# ---------------------------------------------------------------------------
# the cluster's reductions, emulated in float32


def emulate_cluster(x, fmt, mode="gather", fault=None):
    """The kernel's arithmetic on a CPU tensor ``[rows, d]``: each rank's
    slice snapped, the row max of the ranks' maxes, per-rank float32 sums of
    p (gather / onehot) added in rank order, or integer counts summed across
    ranks and dotted with the VMM table in level order (histogram); the ADC
    gain's division after the row, as the wrapper does."""
    rows, d = x.shape
    c = sk.cluster_size(d)
    s = sk.slice_len(d, c)
    lut, vmm, remap = (t.cpu().numpy() for t in sk._tables(fmt, mode, fault, "cpu"))
    levels = fmt.num_levels
    j = quantize_logits(x.float(), fmt).numpy().astype(np.int64)
    out = np.zeros((rows, d), np.float32)
    for r in range(rows):
        slices = [j[r, q * s:(q + 1) * s] for q in range(c)]
        m = max(int(sl.max()) for sl in slices if sl.size)
        k2 = [remap[np.clip(m - sl, 0, levels - 1)] for sl in slices]
        if mode == "histogram":
            counts = sum(np.bincount(k, minlength=levels) for k in k2)
            den = np.float32(0)
            for lvl in range(levels):
                den = np.float32(den + np.float32(np.float32(counts[lvl]) * vmm[lvl]))
        else:
            den = np.float32(0)
            for k in k2:  # rank order
                den = np.float32(den + lut[k].astype(np.float32).sum(dtype=np.float32))
        if den <= 0:
            den = np.float32(1)
        out[r] = (lut[np.concatenate(k2)] / den).astype(np.float32)
    if mode == "histogram" and not tf.is_null(fault):
        gain = tf.adc_gain(fault)
        if gain is not None:
            out = out / np.float32(gain)
    return torch.as_tensor(out)


def _logits(seed, rows, d, dtype=torch.float32, specials=True):
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(rows, d)) * 4,
                        dtype=torch.float32)
    if specials and d > 3:
        x[:, :d // 8] = -float("inf")
        x[0, 1] = float("nan")
    return x.to(dtype)


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "mild"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows,d", [(1, 17), (4, 4097), (3, 9000), (2, 49152), (1, 50688)])
def test_cluster_emulation_matches_plain(rows, d, mode, faulty):
    fault = tf.FaultModel(**MILD) if faulty else None
    for dtype in (torch.float32, torch.bfloat16):
        x = _logits(41 + d, rows, d, dtype)
        got = emulate_cluster(x, FMT, mode, fault)
        ref = sk.star_softmax_ref(x, FMT, mode=mode, fault=fault)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("rows,d", [(3, 50), (2, 4097), (1, 49152)])
def test_cluster_emulation_matches_the_jax_package(rows, d, jax_ref):
    """Clean gather against the JAX Pallas kernel in interpret mode (finite
    logits: its kernel wraps -inf to level 0, a fault the port does not
    copy), and every mode against the JAX reference engine with -inf."""
    x = _logits(43, rows, d, specials=False)
    got = emulate_cluster(x, FMT)
    ref = np.asarray(jax_star(jnp.asarray(x.numpy()), fmt=JFMT, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-9)
    x = _logits(44, rows, d)
    x[0, 1] = 0.0  # NaN is the port's sentinel; keep the engines' inputs alike
    for mode in MODES:
        got = emulate_cluster(x, FMT, mode)
        ref = np.asarray(jax_core_softmax.star_softmax(jnp.asarray(x.numpy()), JFMT, mode=mode))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-9)


def test_onehot_emulation_is_gather_bit_for_bit():
    x = _logits(45, 4, 49152)
    assert torch.equal(emulate_cluster(x, FMT, "onehot"), emulate_cluster(x, FMT, "gather"))


# ---------------------------------------------------------------------------
# the wrapper, through a fake library


class _FakeLib:
    def __init__(self):
        self.calls = []

    def star_softmax_lut_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "mild"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_mode_is_one_launch_of_the_cluster_kernel(mode, faulty, dtype, monkeypatch):
    fault = tf.FaultModel(**MILD) if faulty else None
    lib = _FakeLib()
    monkeypatch.setattr(sk._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(sk._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(sk._cuda, "stream_handle", lambda device: 0)
    x = _logits(46, 2 * 3, 50688, dtype).reshape(2, 3, 50688)
    counted = sk.LAUNCHES if (not faulty and mode != "histogram") else sk.LUT_LAUNCHES
    other = sk.LUT_LAUNCHES if counted is sk.LAUNCHES else sk.LAUNCHES
    before, before_other = counted.count, other.count
    out = sk.star_softmax_kernel(x, FMT, mode=mode, fault=fault)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert counted.count == before + 1 and other.count == before_other
    assert len(lib.calls) == 1
    args = lib.calls[0]
    assert args[0] == x.data_ptr() and args[5:9] == (6, 50688, 8, 6336)
    assert args[9:13] == (50688, 50688, sk.DTYPES[dtype], int(mode == "histogram"))
    assert args[13] == float(FMT.scale) and args[14] == FMT.num_levels


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(sk._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(sk._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(sk._cuda, "stream_handle", lambda device: 0)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        sk.star_softmax_kernel(torch.zeros(2, 8, dtype=torch.float16), FMT)
    with pytest.raises(ValueError, match="contiguous last axis"):
        sk.star_softmax_kernel(torch.zeros(8, 2).t(), FMT)
    from repro_torch.core.fixedpoint import FixedPointFormat

    with pytest.raises(ValueError, match="levels"):
        sk.star_softmax_kernel(torch.zeros(2, 8), FixedPointFormat(10, 3))
    assert not lib.calls


# ---------------------------------------------------------------------------
# on the card


CARD_ROWS = (1, 4, 8, 33)
CARD_D = (1, 17, 4097, 49152, 50688)


@pytest.mark.cuda
@pytest.mark.parametrize("faulty", [False, True], ids=["clean", "mild"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_kernel_matches_plain_on_card(cuda, dtype, mode, faulty):
    """rows {1, 4, 8, 33} x d {1, 17, 4097, 49152, 50688}, -inf and NaN
    columns included: one launch each, within rtol 1e-5, atol 1e-9 of the
    plain version; onehot bit-equal to gather."""
    fault = tf.FaultModel(**MILD) if faulty else None
    for rows in CARD_ROWS:
        for d in CARD_D:
            x = _logits(47 + rows + d, rows, d, dtype).to(cuda)
            before = sk.LAUNCHES.count + sk.LUT_LAUNCHES.count
            got = sk.star_softmax_kernel(x, FMT, mode=mode, fault=fault)
            assert sk.LAUNCHES.count + sk.LUT_LAUNCHES.count == before + 1
            ref = sk.star_softmax_ref(x, FMT, mode=mode, fault=fault)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-9)
            if mode == "onehot":
                assert torch.equal(got, sk.star_softmax_kernel(x, FMT, mode="gather",
                                                               fault=fault))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cluster_kernel_walks_long_rows_in_rounds_on_card(cuda, mode):
    """2^20 columns: eight CTAs a row, each slice longer than its registers
    hold, read again in each phase; a row view with an odd stride goes
    element by element."""
    x = _logits(48, 2, 2 ** 20).to(cuda)
    got = sk.star_softmax_kernel(x, FMT, mode=mode)
    torch.testing.assert_close(got, sk.star_softmax_ref(x, FMT, mode=mode), rtol=1e-5, atol=1e-9)
    view = _logits(49, 3, 5001).to(cuda)[:, 1:]
    got = sk.star_softmax_kernel(view, FMT, mode=mode)
    torch.testing.assert_close(got, sk.star_softmax_ref(view, FMT, mode=mode), rtol=1e-5,
                               atol=1e-9)


@pytest.mark.cuda
def test_cluster_kernel_is_deterministic_on_card(cuda):
    x = _logits(50, 8, 50688).to(cuda)
    for mode in MODES:
        first = sk.star_softmax_kernel(x, FMT, mode=mode)
        assert all(torch.equal(first, sk.star_softmax_kernel(x, FMT, mode=mode)) for _ in range(3))
