"""The last three dense archs (qwen2-72b, deepseek-coder-33b, llama3-405b)
and the kernels at head_dim 8, against the JAX reference.

The smoke configs of deepseek-coder-33b (d_model 56 over 7 heads, one KV
head: D 8, a GQA group of 7) and llama3-405b (64 over 8 heads, 2 KV heads:
D 8, group 4) are the configs that need flash_star and the paged decode
kernel at D 8.  Weights and inputs come from seeds through numpy
(``from_reference``).  The JAX side keeps its default routes (attention
``xla``, softmax ``reference``); the port runs ``attn_impl="pallas"`` under
``ops.use(softmax="pallas")``, so attention and sampling go through the
kernel wrappers, which run their plain versions on the CPU.  Tolerances:
logits at ``atol=1e-4`` (float32 sums in another order); greedy tokens
identical; the plain versions against the JAX kernels in interpret mode on
dyadic inputs (every q.k exact in any order) at ``atol=1e-5``.

The zero-padded QK^T that the bf16 kernels run at D 8 (Q and K at 16
columns, the last 8 zero, ``sm_scale`` at the true D) is emulated in
float32 against the plain version; the wrappers' routing of D 8 goes
through a fake library.  The ``cuda`` tests hold both kernels at D 8 to
their plain versions on the card, every kind and page type, and the paged
kernel at G 7 bit-equal under batch invariance; they skip where there is no
card.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import kvquant
from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.models.param import count_params, from_reference
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import (
    ContinuousBatchingEngine,
    ContinuousConfig,
    ServeConfig,
    ServeEngine,
)

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
    from repro.kernels.paged_attention.kernel import paged_flash_attention as jax_paged
    from repro.models.param import count_params as jax_count_params
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
    from repro.serve.engine import ContinuousConfig as JaxConfig
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro.serve.engine import ServeEngine as JaxServeEngine
except ImportError:
    jax = None

flash_mod = importlib.import_module("repro_torch.kernels.flash_star.kernel")
paged_mod = importlib.import_module("repro_torch.kernels.paged_attention.kernel")

ARCHS = ("qwen2_72b", "deepseek_coder_33b", "llama3_405b")
ATOL = 1e-4  # logits
KERNEL_ATOL = 1e-5  # plain versions vs the JAX kernels on dyadic inputs
MAX_LEN = 40
D8 = 8


@pytest.fixture(scope="module")
def pairs():
    """Per arch: the JAX smoke config and weights, the port's config and the
    same weights."""
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    out = {}
    for arch in ARCHS:
        cfg_j = jax_smoke_config(arch)
        params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
        cfg_t = dataclasses.replace(get_smoke_config(arch), attn_impl="pallas")
        params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                                  device="cpu")
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    return out


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


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_follow_the_reference_field_for_field(arch, jax_ref):
    """Both configs field for field (the reference's sharding / training
    fields aside), the published widths, the parameter counts of both
    packages, and the smoke configs' head dims and groups."""
    assert arch in ARCH_IDS
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in dataclasses.fields(mine):
            if f.name not in ("softmax", "attention"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    full = get_config(arch)
    got = (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.d_ff,
           full.vocab_size)
    want = {"qwen2_72b": (80, 8192, 64, 8, 29568, 152064),
            "deepseek_coder_33b": (62, 7168, 56, 8, 19200, 32256),
            "llama3_405b": (126, 16384, 128, 8, 53248, 128256)}[arch]
    assert got == want
    n = count_params(build_model(full).param_specs())
    assert n == jax_count_params(jax_build_model(jax_config(arch)).param_specs())
    lo, hi = {"qwen2_72b": (70e9, 75e9), "deepseek_coder_33b": (32e9, 35e9),
              "llama3_405b": (400e9, 410e9)}[arch]
    assert lo < n < hi
    smoke = get_smoke_config(arch)
    d, g = smoke.resolved_head_dim, smoke.num_heads // smoke.num_kv_heads
    assert (d, g) == {"qwen2_72b": (16, 2), "deepseek_coder_33b": (8, 7),
                      "llama3_405b": (8, 4)}[arch]


# ---------------------------------------------------------------------------
# the model and the engines against JAX


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch, pairs):
    """A batch-2 prefill and three lockstep decode steps: logits at ATOL."""
    cfg_j, params_j, cfg_t, params_t = pairs[arch]
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    prompts = np.stack(_prompts(1, (17, 17)))
    lg_j, c_j = mj.prefill(params_j, jnp.asarray(prompts), MAX_LEN)
    with ops.use(softmax="pallas"):
        lg_t, c_t = mt.prefill(params_t, torch.as_tensor(prompts), MAX_LEN)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)
        assert int(c_t["len"]) == int(c_j["len"]) and int(c_t["pos"]) == int(c_j["pos"])
        step_j = jax.jit(mj.decode_step)
        rng = np.random.default_rng(2)
        for _ in range(3):
            tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
            lg_j, c_j = step_j(params_j, c_j, jnp.asarray(tok))
            lg_t, _ = mt.decode_step(params_t, c_t, torch.as_tensor(tok))
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_tokens_match_the_jax_serve_engine(arch, pairs):
    cfg_j, params_j, cfg_t, params_t = pairs[arch]
    prompts = np.stack(_prompts(3, (9, 9, 9)))
    want, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)
                                  ).generate(jnp.asarray(prompts), 12)
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN), device="cpu")
        got, info = eng.generate(prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert info == info_j
    assert (eng.graphs.entries(), eng.graphs.replays) == (1, 11)


ENGINE_PATHS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged", kv_block_size=4),
    "paged_int8": dict(kv_layout="paged", kv_block_size=4, kv_dtype="int8"),
}


@pytest.mark.parametrize("path", list(ENGINE_PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_tokens_match_the_jax_engine(arch, path, pairs):
    """Greedy tokens on the dense and paged layouts and over an int8 page
    pool (D 8: 8-byte code rows), the port's paged route through the kernel
    wrapper's plain version."""
    cfg_j, params_j, cfg_t, params_t = pairs[arch]
    prompts, gens = _prompts(4, (11, 19, 5, 14)), [5, 7, 4, 6]
    kw = ENGINE_PATHS[path]
    want = JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN, **kw)
                     ).serve(prompts, gens)
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, **kw), device="cpu")
        got = eng.serve(prompts, gens)
    assert got == want
    assert eng.kv_layout == kw["kv_layout"]
    assert eng.graph_entries() == 1 and eng.graphs.replays == eng.ticks


# ---------------------------------------------------------------------------
# the kernels' plain versions at D 8 against the JAX kernels

FLASH_D8_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 7, 1, 13, 13, True, None, 0, None),       # deepseek's group of 7
    (2, 8, 2, 9, 29, True, None, 20, (29, 17)),   # llama3's group of 4, q_offset, ragged
    (2, 7, 1, 1, 19, False, None, 0, (19, 6)),    # a dense decode step (Tq = 1)
    (1, 8, 2, 24, 24, True, 7, 0, None),          # sliding window
]


@pytest.mark.parametrize("pv_int8", [False, True], ids=["float_pv", "pv_int8"])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", FLASH_D8_CASES)
def test_flash_star_plain_matches_pallas_at_d8(case, star, pv_int8, jax_ref):
    b, hq, hkv, tq, tk, causal, window, q_off, kvl = case
    rng = np.random.default_rng(21)
    q, k, v = _dyadic(rng, (b, hq, tq, D8)), _dyadic(rng, (b, hkv, tk, D8)), \
        _dyadic(rng, (b, hkv, tk, D8))
    info = np.array([q_off] + list(kvl or [tk] * b), np.int32)
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(info),
        fmt=JFMT if star else None, causal=causal, sliding_window=window,
        block_q=8, block_k=8, pv_int8=pv_int8, interpret=True))
    got = flash_mod.flash_star_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(info),
        fmt=FMT if star else None, causal=causal, sliding_window=window, block_k=8,
        pv_int8=pv_int8)
    np.testing.assert_allclose(got.numpy(), ref, atol=KERNEL_ATOL, rtol=0)


PAGED_D8_CASES = [
    # s, w, bs, hq, hkv, lens  (a 0 is a free slot)
    (3, 4, 8, 7, 1, (6, 25, 0)),        # G 7
    (4, 3, 16, 8, 2, (16, 17, 48, 1)),  # G 4
]


def _quantized(a, kv_dtype):
    codes, scale = kvquant.quantize_blocks(torch.as_tensor(a), kv_dtype)
    return codes, scale


@pytest.mark.parametrize("pool", ["fp32", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", PAGED_D8_CASES)
def test_paged_plain_matches_pallas_at_d8(case, star, pool, jax_ref):
    """fp32 pools and int8 / fp8 codes with per-(block, head) scales (the
    codes and scales ``kvquant.quantize_blocks`` makes, handed to both)."""
    s, w, bs, hq, hkv, lens = case
    rng = np.random.default_rng(22)
    n = s * w + 1
    q = _dyadic(rng, (s, hq, D8))
    kp, vp = _dyadic(rng, (n, bs, hkv, D8)), _dyadic(rng, (n, bs, hkv, D8))
    tables = rng.permutation(np.arange(1, n))[: s * w].reshape(s, w).astype(np.int32)
    kvl = np.asarray(lens, np.int32)
    kw_t, kw_j = {}, {}
    pools_t = (torch.as_tensor(kp), torch.as_tensor(vp))
    pools_j = (jnp.asarray(kp), jnp.asarray(vp))
    if pool != "fp32":
        (kc, ks), (vc, vs) = _quantized(kp, pool), _quantized(vp, pool)
        pools_t = (kc, vc)
        pools_j = tuple(jnp.asarray(kvquant.indexable(c).numpy()).view(
            jnp.int8 if pool == "int8" else jnp.float8_e4m3fn) for c in (kc, vc))
        kw_t = dict(k_scale=ks, v_scale=vs)
        kw_j = dict(k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    ref = np.asarray(jax_paged(jnp.asarray(q), *pools_j, jnp.asarray(tables), jnp.asarray(kvl),
                               fmt=JFMT if star else None, interpret=True, **kw_j))
    got = paged_mod.paged_flash_attention(
        torch.as_tensor(q), *pools_t, torch.as_tensor(tables), torch.as_tensor(kvl),
        fmt=FMT if star else None, **kw_t)
    np.testing.assert_allclose(got.numpy(), ref, atol=KERNEL_ATOL, rtol=0)
    assert not got[kvl == 0].any()


# ---------------------------------------------------------------------------
# the zero-padded QK^T of the bf16 kernels at D 8


def _pad16(x):
    return torch.nn.functional.pad(x, (0, 16 - x.shape[-1]))


@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_zero_padded_qk_emulation_equals_the_plain_version(star):
    """Q and K at 16 columns (8 of them zero) with ``sm_scale`` at the true
    D: a float32 QK^T in 16-wide k steps (the kernel's m16n8k16) equals the
    8-term dot bit for bit, and the attention over the padded operands is the
    plain version's at D 8 exactly; at the padded width's own scale it is
    not (the scale is what the wrapper must keep)."""
    g = torch.Generator().manual_seed(31)
    q, k, v = (torch.randn(sh, generator=g) for sh in ((1, 7, 40, D8), (1, 1, 40, D8),
                                                       (1, 1, 40, D8)))
    q, k, v = (x.to(torch.bfloat16).float() for x in (q, k, v))  # the bf16 kernel's operands
    # each product of bf16 values is exact in float32: the padded sum adds
    # the same 8 products, then 8 exact zeros
    s8 = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(7, 1))
    prods = _pad16(q)[:, :, :, None, :] * _pad16(k).repeat_interleave(7, 1)[:, :, None, :, :]
    s16 = torch.zeros_like(s8)
    for c in range(16):  # one k step of 16, summed column by column in float32
        s16 = s16 + prods[..., c]
    s8_seq = torch.zeros_like(s8)
    for c in range(D8):
        s8_seq = s8_seq + prods[..., c]
    assert torch.equal(s16, s8_seq)
    torch.testing.assert_close(s16, s8, atol=1e-5, rtol=1e-5)
    info = torch.tensor([0, 40], dtype=torch.int32)
    fmt = FMT if star else None
    want = flash_mod.flash_star_ref(q, k, v, info, fmt=fmt)
    padded = flash_mod.flash_star_ref(_pad16(q), _pad16(k), _pad16(v), info, fmt=fmt,
                                      sm_scale=D8 ** -0.5)
    assert torch.equal(padded[..., D8:], torch.zeros_like(padded[..., D8:]))
    torch.testing.assert_close(padded[..., :D8], want, atol=0, rtol=0)
    wrong = flash_mod.flash_star_ref(_pad16(q), _pad16(k), _pad16(v), info, fmt=fmt)
    assert not torch.allclose(wrong[..., :D8], want, atol=1e-3)


# ---------------------------------------------------------------------------
# the wrappers' routing of D 8 (a fake library)


class _FakeLib:
    def __init__(self, entries):
        self.calls = []
        for name in entries:
            setattr(self, name, self._entry(name))

    def _entry(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


def _fake(monkeypatch, mod, entries):
    lib = _FakeLib(entries)
    monkeypatch.setattr(mod._cuda, "on_card", lambda t: True)
    monkeypatch.setattr(mod._cuda, "load", lambda source, bind: lib)
    monkeypatch.setattr(mod._cuda, "stream_handle", lambda device: 0)
    return lib


@pytest.mark.parametrize("dtype,pv_int8,entries", [
    (torch.bfloat16, False, ["flash_star_mma_launch"]),
    (torch.float32, False, ["flash_star_tf32_launch"]),
    (torch.bfloat16, True, ["flash_star_quantize_v_launch", "flash_star_pv_int8_launch"]),
    (torch.float32, True, ["flash_star_quantize_v_launch", "flash_star_pv_int8_launch"]),
])
def test_flash_star_wrapper_routes_d8_to_the_kernel(dtype, pv_int8, entries, monkeypatch):
    """A D-8 call reaches the CUDA entry of its kind with D 8 and the true
    D's scale (a bf16 row of 8 is one 16-byte piece: the check passes), as
    the transposed ``[B, T, H, D]`` views of the ops layer; D 24 is still
    refused before any launch."""
    lib = _fake(monkeypatch, flash_mod, (
        "flash_star_mma_launch", "flash_star_tf32_launch", "flash_star_quantize_v_launch",
        "flash_star_pv_int8_launch"))
    g = torch.Generator().manual_seed(32)
    q, k, v = (torch.randn(sh, generator=g).to(dtype).transpose(1, 2)
               for sh in ((2, 33, 7, D8), (2, 33, 1, D8), (2, 33, 1, D8)))
    info = torch.tensor([0, 33, 20], dtype=torch.int32)
    before = flash_mod.LAUNCHES.count + flash_mod.PV_INT8_LAUNCHES.count
    out = flash_mod.flash_star_attention(q, k, v, info, fmt=FMT, block_k=32, pv_int8=pv_int8)
    assert out.shape == (2, 7, 33, D8) and out.dtype == dtype
    assert [name for name, _ in lib.calls] == entries
    assert flash_mod.LAUNCHES.count + flash_mod.PV_INT8_LAUNCHES.count == before + 1
    args = lib.calls[-1][1]
    assert args[18:24] == (2, 7, 1, 33, 33, D8)  # B Hq Hkv Tq Tk D
    scale_at = 24 + pv_int8 + 2  # after the dtype code (pv_int8), causal and window
    assert args[scale_at] == pytest.approx(D8 ** -0.5)
    if pv_int8:
        assert lib.calls[0][1][4:10] == (2, 1, 33, D8, 1 if dtype == torch.bfloat16 else 0, 32)
    lib.calls.clear()
    with pytest.raises(ValueError, match="head_dim in"):
        q24 = torch.zeros(1, 2, 4, 24, dtype=dtype)
        flash_mod.flash_star_attention(q24, q24, q24, torch.tensor([0, 4], dtype=torch.int32),
                                       fmt=FMT)
    assert lib.calls == []


@pytest.mark.parametrize("pool", ["fp32", "int8", "fp8_e4m3"])
def test_paged_wrapper_routes_d8_to_the_kernel(pool, monkeypatch):
    """The paged wrapper hands a D-8 pool (bf16 values, or 1-byte codes with
    their scale pages: 8-byte rows) to its CUDA entry untouched, with D 8;
    G 7 passes the group check."""
    lib = _fake(monkeypatch, paged_mod, ("paged_attention_launch",
                                         "paged_attention_quant_launch"))
    s, w, bs, hq, hkv = 3, 4, 16, 7, 1
    g = torch.Generator().manual_seed(33)
    q = torch.randn(s, hq, D8, generator=g).to(torch.bfloat16)
    kp, vp = (torch.randn(s * w + 1, bs, hkv, D8, generator=g) for _ in range(2))
    tables = torch.arange(1, s * w + 1, dtype=torch.int32).reshape(s, w)
    kvl = torch.tensor([5, 64, 0], dtype=torch.int32)
    kw = {}
    if pool == "fp32":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
        entry = "paged_attention_launch"
    else:
        (kp, ks), (vp, vs) = (kvquant.quantize_blocks(x, pool) for x in (kp, vp))
        kw = dict(k_scale=ks, v_scale=vs)
        entry = "paged_attention_quant_launch"
    out = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=FMT, **kw)
    assert out.shape == (s, hq, D8) and out.dtype == torch.bfloat16
    assert [name for name, _ in lib.calls] == [entry]
    args = lib.calls[0][1]
    ints = args[9:15] if pool != "fp32" else args[7:13]
    assert ints == (s, hq, hkv, w, bs, D8)
    assert args[1] == kp.data_ptr() and args[2] == vp.data_ptr()


def test_sources_take_head_dim_8():
    """Both sources dispatch D 8, the paged kernel refuses at compile time a
    row that does not split into whole copy pieces, and the pre-pass of the
    int8 P.V variant takes D 8."""
    fsrc, psrc = flash_mod.SOURCE.read_text(), paged_mod.SOURCE.read_text()
    assert 8 in flash_mod.HEAD_DIMS and 8 in paged_mod.HEAD_DIMS
    assert "case 8: return star ? launch_kind<KIND, true, 8>" in fsrc
    assert "case 8: return launch<T, C, 8, STAR>(p, stream);" in psrc
    assert "static_assert(CPR >= 1 && CPR * PIECE == RB" in psrc
    assert "D < 8 || D > QV_MAX_D || D % 8" in fsrc
    assert "cp.async.ca.shared.global [%0], [%1], %2;" in psrc


# ---------------------------------------------------------------------------
# on the card: both kernels at D 8 (and the paged kernel at G 7)

CARD_FLASH_D8 = FLASH_D8_CASES + [
    (1, 7, 1, 130, 130, True, None, 0, None),          # across 64-row tiles, group 7
    (2, 8, 2, 65, 265, True, None, 200, (265, 190)),   # q_offset, ragged, group 4
    (4, 7, 1, 1, 200, False, None, 0, (200, 131, 1, 77)),  # the dense decode, Tq = 1
]


def _tol(dtype):
    # bf16 outputs: both round one float32 value after sums in another order
    if dtype == torch.bfloat16:
        return dict(atol=8e-3, rtol=8e-3)
    return dict(atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_flash_star_kernel_at_d8_matches_plain_on_card(cuda, dtype, star):
    """Dyadic operands (every score exact in any order): the bf16 kernel
    (zero-padded QK^T) and the tf32 kernel at D 8 against the plain version,
    heads-major and as transposed views, one launch a call."""
    rng = np.random.default_rng(34)
    for b, hq, hkv, tq, tk, causal, window, q_off, kvl in CARD_FLASH_D8:
        for transposed in (False, True):
            shapes = ((b, hq, tq, D8), (b, hkv, tk, D8), (b, hkv, tk, D8))
            if transposed:
                shapes = [(sh[0], sh[2], sh[1], sh[3]) for sh in shapes]
            q, k, v = (torch.as_tensor(_dyadic(rng, sh), device=cuda).to(dtype) for sh in shapes)
            if transposed:
                q, k, v = (x.transpose(1, 2) for x in (q, k, v))
            info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32, device=cuda)
            kw = dict(fmt=FMT if star else None, causal=causal, sliding_window=window)
            before = flash_mod.LAUNCHES.count
            got = flash_mod.flash_star_attention(q, k, v, info, **kw)
            assert flash_mod.LAUNCHES.count == before + 1
            ref = flash_mod.flash_star_ref(q, k, v, info, **kw)
            torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_pv_int8_kernel_at_d8_matches_plain_on_card(cuda, dtype, star):
    """The int8 P.V variant at D 8 (its s8 fold cut to 8 features): dyadic q
    and k (equal codes), normal v, blocks of 16 to 128 rows; the pre-pass's
    codes and scales equal the plain layout bit for bit."""
    from repro_torch.kernels.flash_star import ref as ref_mod

    rng = np.random.default_rng(35)
    for b, hq, hkv, tq, tk, causal, window, q_off, kvl in CARD_FLASH_D8:
        for bk in (16, 20, 100, 128):
            q, k = (torch.as_tensor(_dyadic(rng, sh), device=cuda).to(dtype)
                    for sh in ((b, hq, tq, D8), (b, hkv, tk, D8)))
            v = torch.as_tensor(rng.normal(size=(b, hkv, tk, D8)).astype(np.float32),
                                device=cuda).to(dtype)
            info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32, device=cuda)
            kw = dict(fmt=FMT if star else None, causal=causal, sliding_window=window,
                      block_k=bk, pv_int8=True)
            before = flash_mod.PV_INT8_LAUNCHES.count
            got = flash_mod.flash_star_attention(q, k, v, info, **kw)
            assert flash_mod.PV_INT8_LAUNCHES.count == before + 1
            ref = flash_mod.flash_star_ref(q, k, v, info, **kw)
            torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
            bk_eff = min(bk, tk)
            lib = flash_mod._cuda.load(flash_mod.SOURCE, flash_mod._bind)
            codes, scales = flash_mod._quantize_v(lib, v, bk_eff,
                                                  flash_mod._cuda.stream_handle(cuda))
            want_codes, want_scales = ref_mod.quantize_v_blocks(v, bk_eff)
            assert torch.equal(codes, ref_mod.v8_layout(want_codes, bk_eff))
            assert torch.equal(scales, want_scales)


PAGED_CARD = [
    # w, bs, lens
    (63, 16, (600, 1000, 0, 1)),
    (3, 128, (300, 129)),    # splits of half a page
    (130, 1, (130, 0, 64)),  # 64 pages a split
    (8, 48, (300, 47)),      # splits that start inside a page
]
PAGED_GROUPS = ((7, 1), (8, 2), (28, 4))  # (hq, hkv): G 7, 4, 7 (qwen2-vl's heads)


def _paged_card_operands(rng, pool, s, w, bs, hq, hkv, d, lens, dev):
    n = s * w + 1
    q = torch.as_tensor(_dyadic(rng, (s, hq, d)), device=dev)
    kp, vp = (torch.as_tensor(_dyadic(rng, (n, bs, hkv, d)), device=dev) for _ in range(2))
    kw = {}
    if pool != "fp32":
        (kp, ks), (vp, vs) = (kvquant.quantize_blocks(x, pool) for x in (kp, vp))
        kw = dict(k_scale=ks, v_scale=vs)
    tables = torch.as_tensor(
        rng.permutation(np.arange(1, n))[: s * w].reshape(s, w).astype(np.int32), device=dev)
    return q, kp, vp, tables, torch.as_tensor(np.asarray(lens, np.int32), device=dev), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("pool", ["fp32", "int8", "fp8_e4m3"])
def test_paged_kernel_at_d8_and_g7_matches_plain_on_card(cuda, pool, star, dtype):
    """D 8 (rows of 8 one-byte codes: 8-byte copies) and D 128, over q's
    type and over int8 / fp8 pages, at G 7, 4 and qwen2-vl's 28:4."""
    rng = np.random.default_rng(36)
    for w, bs, lens in PAGED_CARD:
        for d in (D8, 128):
            for hq, hkv in PAGED_GROUPS:
                q, kp, vp, tables, kvl, kw = _paged_card_operands(
                    rng, pool, len(lens), w, bs, hq, hkv, d, lens, cuda)
                q = q.to(dtype)
                if pool == "fp32":
                    kp, vp = kp.to(dtype), vp.to(dtype)
                kw.update(fmt=FMT if star else None)
                got = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, **kw)
                ref = paged_mod.paged_attention_ref(q, kp, vp, tables, kvl, **kw)
                torch.testing.assert_close(got.float(), ref.float(), **_tol(dtype))
                assert not got[kvl == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [D8, 128])
@pytest.mark.parametrize("pool", ["fp32", "int8", "fp8_e4m3"])
def test_paged_kernel_at_g7_is_batch_invariant_on_card(cuda, pool, d):
    """G 7 (28:4): a slot of a batch of 4 under a 70-block table (through the
    combine) gives the same bits as the slot alone under the narrowest table
    that holds it, and as the batch under a 63-block table."""
    rng = np.random.default_rng(37)
    lens, bs = (1000, 600, 64, 17), 16
    q, kp, vp, tables, kvl, kw = _paged_card_operands(rng, pool, 4, 70, bs, 28, 4, d, lens, cuda)
    q = q.to(torch.bfloat16)
    if pool == "fp32":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    batch = paged_mod.paged_flash_attention(q, kp, vp, tables, kvl, fmt=FMT, **kw)
    narrow = paged_mod.paged_flash_attention(q, kp, vp, tables[:, :63].contiguous(), kvl,
                                             fmt=FMT, **kw)
    for slot, n in enumerate(lens):
        w_alone = -(-n // bs)
        alone = paged_mod.paged_flash_attention(
            q[slot:slot + 1].contiguous(), kp, vp, tables[slot:slot + 1, :w_alone].contiguous(),
            kvl[slot:slot + 1], fmt=FMT, **kw)
        assert torch.equal(alone[0], batch[slot]), slot
        assert torch.equal(narrow[slot], batch[slot]), slot
