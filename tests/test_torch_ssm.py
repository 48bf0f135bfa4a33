"""The port's Mamba2 path against the JAX reference on the same inputs and
weights: the causal conv, the SSD chunk scan's plain version (against the
JAX Pallas kernel in interpret mode, as ``tests/test_kernels_ssd_scan.py``
runs it), ``ops.ssd_scan``, ``MambaLM`` forward / prefill / decode, and the
lockstep ``ServeEngine``'s greedy tokens.  The ``cuda`` test holds the CUDA
kernel to its plain version on the card and skips where there is none.

Tolerances: the conv is a few float32 products, atol 1e-6; the scan keeps
the reference test's own atol 1e-4 (float32 sums in another order over up
to 128 chunk steps); logits hold to 1e-5 of their largest magnitude (the
same function in float32, sums in another order); greedy tokens are equal.
"""

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssd_scan import kernel as ssd_mod
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.param import from_reference
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import (
    ContinuousBatchingEngine,
    ServeConfig,
    ServeEngine,
    sample_token,
)

try:  # the machine with the card runs the ``cuda`` test without JAX
    import jax
    import jax.numpy as jnp

    from repro import ops as jops
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.kernels.ssd_scan.kernel import ssd_scan_pallas as jax_ssd_scan
    from repro.models import layers as JL
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ServeConfig as JServeConfig
    from repro.serve.engine import ServeEngine as JServeEngine
except ImportError:
    jax = None

ARCH = "mamba2_130m"
SCAN_ATOL = 1e-4
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scan_inputs(b, t, h, p, n, seed=13):
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(b, t, h, p)).astype(np.float32)
    a = -np.abs(rng.normal(size=(b, t, h)) * 0.1).astype(np.float32)
    bm = (rng.normal(size=(b, t, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(b, t, n)) * 0.3).astype(np.float32)
    return xdt, a, bm, cm


def _torch(*arrays):
    return [torch.as_tensor(x) for x in arrays]


# ---------------------------------------------------------------------------
# the causal conv


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state, jax_ref):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    yj, sj = JL.causal_conv1d({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                              None if state is None else jnp.asarray(state))
    yt, st = L.causal_conv1d({"kernel": torch.as_tensor(w)}, torch.as_tensor(x),
                             None if state is None else torch.as_tensor(state))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6, rtol=0)
    if with_state:
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    else:
        assert st is None and sj is None


# ---------------------------------------------------------------------------
# the SSD chunk scan

SCAN_DIMS = [
    (2, 64, 4, 16, 32, 16),
    (1, 100, 3, 8, 16, 32),  # ragged tail (100 % 32 != 0)
    (2, 128, 24, 64, 128, 128),  # mamba2-130m geometry
    (1, 33, 2, 8, 8, 64),  # chunk > T
]


@pytest.mark.parametrize("dims", SCAN_DIMS, ids=lambda d: "x".join(map(str, d)))
def test_ssd_scan_plain_matches_pallas(dims, jax_ref):
    b, t, h, p, n, chunk = dims
    xdt, a, bm, cm = _scan_inputs(b, t, h, p, n)
    yj, hj = jax_ssd_scan(*map(jnp.asarray, (xdt, a, bm, cm)), chunk=chunk, interpret=True)
    yt, ht = ssd_mod.ssd_scan(*_torch(xdt, a, bm, cm), chunk=chunk)
    assert yt.dtype == ht.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=SCAN_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["pallas", "reference"])
def test_ops_ssd_scan_impls_match_reference_op(impl, jax_ref):
    xdt, a, bm, cm = _scan_inputs(2, 50, 3, 8, 16, seed=4)
    yj, hj = jops.ssd_scan(*map(jnp.asarray, (xdt, a, bm, cm)),
                           jops.ScanSpec(impl="reference", chunk=16))
    yt, ht = ops.ssd_scan(*_torch(xdt, a, bm, cm), ops.ScanSpec(impl=impl, chunk=16))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=SCAN_ATOL, rtol=0)
    with ops.use(ssd_scan="reference"):
        assert ops.validate(ops.ScanSpec()).impl == "reference"
    with pytest.raises(ValueError, match="chunk"):
        ops.ScanSpec(chunk=0)


def test_ssd_scan_chunk_size_invariance():
    xdt, a, bm, cm = _torch(*_scan_inputs(1, 96, 2, 8, 16))
    outs = [ssd_mod.ssd_scan(xdt, a, bm, cm, chunk=c)[0].numpy() for c in (16, 32, 96)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=SCAN_ATOL, rtol=0)


def test_ssd_scan_state_continues_through_h0():
    """The final state continues the recurrence: the second half seeded
    with the first half's state equals the whole run."""
    xdt, a, bm, cm = _torch(*_scan_inputs(1, 64, 2, 8, 16))
    y_full, h_full = ssd_scan_ref(xdt, a, bm, cm, chunk=16)
    _, h_half = ssd_mod.ssd_scan(xdt[:, :32], a[:, :32], bm[:, :32], cm[:, :32], chunk=16)
    y2, h2 = ssd_scan_ref(xdt[:, 32:], a[:, 32:], bm[:, 32:], cm[:, 32:], chunk=16, h0=h_half)
    np.testing.assert_allclose(y2.numpy(), y_full[:, 32:].numpy(), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=SCAN_ATOL, rtol=0)


def test_ssd_scan_wrapper_checks_shapes():
    xdt, a, bm, cm = _torch(*_scan_inputs(1, 8, 2, 4, 4))
    with pytest.raises(ValueError, match="a \\[B, T, H\\]"):
        ssd_mod.ssd_scan(xdt, a[:, :4], bm, cm)
    with pytest.raises(ValueError, match="B/C"):
        ssd_mod.ssd_scan(xdt, a, bm, cm[:, :, :2])


# ---------------------------------------------------------------------------
# MambaLM against the JAX model, the same weights


@pytest.fixture(scope="module")
def pair(jax_ref):
    cfg_j = jax_smoke_config(ARCH)
    model_j = jax_build_model(cfg_j)
    params_j = jax_materialize(model_j.param_specs(), jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params_j)
    cfg_t = get_smoke_config(ARCH)
    params_t = from_reference(np_params, cfg_t, device="cpu")
    return cfg_j, model_j, params_j, np_params, cfg_t, build_model(cfg_t), params_t


def _assert_logits(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=LOGIT_RTOL * float(np.abs(ref).max()))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_from_reference_carries_the_mamba_tree(pair):
    _, _, _, np_params, _, model_t, params_t = pair
    ref, got = dict(_leaves(np_params)), dict(_leaves(params_t))
    specs = dict(_leaves(model_t.param_specs()))
    assert sorted(ref) == sorted(got) == sorted(specs)
    assert {"/blocks/A_log", "/blocks/D", "/blocks/dt_bias", "/blocks/out_norm"} <= set(got)
    for path, arr in ref.items():
        assert tuple(got[path].shape) == specs[path].shape == arr.shape, path
        np.testing.assert_array_equal(got[path].numpy(), arr, err_msg=path)


def test_forward_and_loss_match_reference(pair):
    cfg_j, model_j, params_j, _, cfg_t, model_t, params_t = pair
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_t.vocab_size, (2, 21)).astype(np.int32)
    labels = rng.integers(-1, cfg_t.vocab_size, (2, 21)).astype(np.int32)
    ref = np.asarray(model_j.forward(params_j, jnp.asarray(tokens)))[..., :cfg_t.vocab_size]
    got = model_t.forward(params_t, torch.as_tensor(tokens))[..., :cfg_t.vocab_size]
    _assert_logits(got, ref)
    loss_j = float(model_j.loss(params_j, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)}))
    loss_t = float(model_t.loss(params_t, {"tokens": torch.as_tensor(tokens),
                                           "labels": torch.as_tensor(labels)}))
    assert loss_t == pytest.approx(loss_j, rel=1e-5)


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and the conv / ssm cache, then three decode steps."""
    cfg_j, model_j, params_j, _, cfg_t, model_t, params_t = pair
    v = cfg_t.vocab_size
    tokens = np.random.default_rng(4).integers(0, v, (2, 19)).astype(np.int32)
    lj, cj = model_j.prefill(params_j, jnp.asarray(tokens), 32)
    lt, ct = model_t.prefill(params_t, torch.as_tensor(tokens), 32)
    _assert_logits(lt[..., :v], np.asarray(lj)[..., :v])
    spec = model_j.cache_spec(2, 32)["layers"]
    for name in ("conv", "ssm"):
        got, ref = ct["layers"][name], np.asarray(cj["layers"][name])
        assert tuple(got.shape) == spec[name].shape == ref.shape
        assert got.dtype == getattr(torch, np.dtype(spec[name].dtype).name)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    nxt = tokens[:, -1:]
    for _ in range(3):
        lj, cj = model_j.decode_step(params_j, cj, jnp.asarray(nxt))
        lt, ct = model_t.decode_step(params_t, ct, torch.as_tensor(nxt))
        _assert_logits(lt[..., :v], np.asarray(lj)[..., :v])
        assert int(ct["len"]) == int(cj["len"])
        nxt = np.asarray(jnp.argmax(lj[..., :v], axis=-1)).astype(np.int32)
    np.testing.assert_allclose(ct["layers"]["ssm"].numpy(), np.asarray(cj["layers"]["ssm"]),
                               atol=1e-5, rtol=0)


def test_prompt_shorter_than_the_conv_zero_fills_its_context(pair):
    """A prompt shorter than ``ssm_conv - 1`` (3) tokens.  The reference keeps
    only the prompt's rows as the conv context (2 of the 3 its cache spec
    declares) and its decode step then raises (recorded in ROADMAP C); the
    port zero-fills the context, as the conv's own zero padding does, so
    prefill + decode equals the forward pass over the three tokens."""
    cfg_j, model_j, params_j, _, cfg_t, model_t, params_t = pair
    v = cfg_t.vocab_size
    _, cj = model_j.prefill(params_j, jnp.asarray([[5, 7]], jnp.int32), 16)
    assert cj["layers"]["conv"].shape[2] == 2
    with pytest.raises(ValueError):
        model_j.decode_step(params_j, cj, jnp.asarray([[9]], jnp.int32))
    _, ct = model_t.prefill(params_t, torch.tensor([[5, 7]]), 16)
    assert ct["layers"]["conv"].shape[2] == cfg_t.ssm_conv - 1
    got, _ = model_t.decode_step(params_t, ct, torch.tensor([[9]]))
    full = model_t.forward(params_t, torch.tensor([[5, 7, 9]]))[:, -1:]
    _assert_logits(got[..., :v], full[..., :v].numpy())
    ref = np.asarray(model_j.forward(params_j, jnp.asarray([[5, 7, 9]], jnp.int32)))[:, -1:]
    _assert_logits(got[..., :v], ref[..., :v])


def test_init_cache_matches_cache_spec(pair):
    _, model_j, _, _, cfg_t, model_t, _ = pair
    cache = model_t.init_cache(3, "cpu")
    spec = model_j.cache_spec(3, 64)["layers"]
    for name in ("conv", "ssm"):
        assert tuple(cache["layers"][name].shape) == spec[name].shape
        assert not cache["layers"][name].any()
    assert cache["layers"]["conv"].dtype == torch.float32 == cache["layers"]["ssm"].dtype
    assert int(cache["len"]) == 0


def test_mixer_routes_reference_and_pallas_alike_on_cpu(pair):
    """On the CPU the kernel backend runs the plain version, so both routes of
    the prefill scan give the same mixer output, bit for bit."""
    *_, cfg_t, model_t, params_t = pair
    x = torch.as_tensor(np.random.default_rng(6).normal(size=(2, 23, cfg_t.d_model)),
                        dtype=torch.float32)
    bp = {k: v[0] for k, v in params_t["blocks"].items() if not isinstance(v, dict)}
    bp["conv"] = {"kernel": params_t["blocks"]["conv"]["kernel"][0]}
    outs = {}
    for impl in ("reference", "pallas"):
        with ops.use(ssd_scan=impl):
            outs[impl] = ssm.mamba_mixer(bp, x, cfg_t, return_state=True)
    assert torch.equal(outs["reference"][0], outs["pallas"][0])
    assert torch.equal(outs["reference"][1]["ssm"], outs["pallas"][1]["ssm"])


# ---------------------------------------------------------------------------
# the lockstep engine


@pytest.mark.parametrize("batch,prompt,gen", [(2, 8, 6), (3, 21, 5)])
def test_lockstep_greedy_tokens_match_reference(pair, batch, prompt, gen):
    cfg_j, _, params_j, _, cfg_t, _, params_t = pair
    prompts = np.random.default_rng(batch).integers(
        0, cfg_t.vocab_size, (batch, prompt)).astype(np.int32)
    ref, info_j = JServeEngine(cfg_j, params_j, JServeConfig(max_len=64)).generate(
        jnp.asarray(prompts), gen)
    got, info_t = ServeEngine(cfg_t, params_t, ServeConfig(max_len=64), device="cpu").generate(
        prompts, gen)
    assert got.dtype == torch.int32 and tuple(got.shape) == (batch, gen)
    assert got.tolist() == np.asarray(ref).tolist()
    assert info_t == info_j == {"cache_len": prompt + gen - 1}


def test_lockstep_sampling_stays_in_vocab_and_is_seeded(pair):
    *_, cfg_t, _, params_t = pair
    prompts = np.random.default_rng(9).integers(0, cfg_t.vocab_size, (3, 10))
    sc = ServeConfig(max_len=64, temperature=0.8)
    with ops.use(softmax="pallas"):
        outs = [ServeEngine(cfg_t, params_t, sc, device="cpu", seed=s).generate(prompts, 8)[0]
                for s in (1, 1, 2)]
    assert all(((o >= 0) & (o < cfg_t.vocab_size)).all() for o in outs)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


def test_sampling_without_star_draws_from_the_exact_softmax(pair):
    """``ServeConfig.star_sampling=False`` (the reference's switch) samples
    from the exact softmax of ``logits / T``, whatever the config's kind."""
    *_, cfg_t, _, _ = pair
    logits = torch.as_tensor(np.random.default_rng(8).normal(size=(3, 512)) * 3,
                             dtype=torch.float32)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    got = sample_token(logits, gens, cfg_t, 0.8, star_sampling=False)
    probs = torch.softmax(logits / 0.8, dim=-1)
    want = [int(torch.multinomial(probs[i], 1, generator=torch.Generator().manual_seed(i)))
            for i in range(3)]
    assert got.tolist() == want
    star = ops.softmax(logits / 0.8, cfg_t.softmax_spec)
    assert not torch.allclose(star, probs)  # the switch changes the distribution


def test_engines_refuse_the_other_family(pair):
    *_, cfg_t, _, params_t = pair
    with pytest.raises(ValueError, match="attention-family"):
        ContinuousBatchingEngine(cfg_t, params_t, device="cpu")


def test_lockstep_launcher_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as launcher

    rc = launcher.main(["--arch", ARCH, "--smoke", "--engine", "lockstep", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "12", "--gen", "4",
                        "--softmax-impl", "pallas"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "generated (2, 4)" in out and "cache_len=15" in out


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version


@pytest.mark.cuda
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_on_card(cuda, bc_dtype):
    """y and the final state within 1e-5 of their largest magnitude (float32
    sums in another order); B and C passed as strided slices."""
    for b, t, h, p, n, chunk in SCAN_DIMS + [(2, 200, 24, 64, 128, 128)]:
        xdt, a, bm, cm = (x.to(cuda) for x in _torch(*_scan_inputs(b, t, h, p, n)))
        bc = torch.cat([bm, cm], dim=-1).to(bc_dtype)
        bm, cm = bc[..., :n], bc[..., n:]
        before = ssd_mod.LAUNCHES.count
        y, hout = ssd_mod.ssd_scan(xdt, a, bm, cm, chunk=chunk)
        assert ssd_mod.LAUNCHES.count == before + 1
        y0, h0 = ssd_scan_ref(xdt, a, bm, cm, chunk=chunk)
        for got, ref in ((y, y0), (hout, h0)):
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
