"""The enc-dec family (seamless-m4t-large-v2: a stub frame frontend, a
non-causal encoder, a causal decoder with cross-attention, LayerNorm and
sinusoidal positions) against the JAX reference.

Weights and inputs come from seeds through numpy (``from_reference``; the
frame embeddings are numpy arrays handed to both).  The JAX side keeps its
default routes (attention ``xla``, softmax ``reference``); the port runs
``attn_impl="pallas"`` under ``ops.use(softmax="pallas")`` where the engine
serves, so attention and sampling go through the kernel wrappers, which run
their plain versions on the CPU.  Tolerances: ``layernorm`` at
``atol=1e-6`` (float32 mean and variance in another order);
``sinusoidal_positions`` within two float32 ulps of its largest angle (at
least 2e-6: ``exp`` / ``sin`` / ``cos`` of two libraries; the angle's ulp
at 3000 is 2.4e-4); the encoder's memory, hidden states, logits and caches
at ``atol=1e-4`` (float32 sums in another order); ``len`` and greedy
tokens identical.

The ``cuda`` test holds the smoke config's lockstep tokens on the card to
the CPU's, with flash_star's launches counted; it skips where there is no
card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels.flash_star import kernel as flash_mod
from repro_torch.launch import serve as launcher
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.param import (
    compute_params,
    count_params,
    from_reference,
    materialize,
    tree_map,
)
from repro_torch.models.registry import build_model
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graph as graph_mod
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeConfig, ServeEngine

try:  # the machine with the card runs the ``cuda`` test without JAX
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import layers as JL
    from repro.models.param import count_params as jax_count_params
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro.serve.engine import ServeEngine as JaxServeEngine
except ImportError:
    jax = None

ARCH = "seamless_m4t_large_v2"
ATOL = 1e-4
MAX_LEN = 40
SRC = 64  # stub frames a request, as the launchers draw them


@pytest.fixture(scope="module")
def pair():
    if jax is None:
        pytest.skip("needs JAX (the reference)")
    cfg_j = jax_smoke_config(ARCH)
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config(ARCH), attn_impl="pallas")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                              device="cpu")
    return cfg_j, params_j, cfg_t, params_t


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


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _frames(seed, b, t=SRC, width=32):
    return np.random.default_rng(seed).standard_normal((b, t, width)).astype(np.float32)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# the config and the layers


def test_configs_and_parameter_count_match_reference(jax_ref):
    assert ARCH in ARCH_IDS
    full = get_config(ARCH)
    for mine, ref in ((full, jax_config(ARCH)), (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name not in ("softmax", "attention"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert full.resolved_head_dim == 64 and full.padded_vocab == 256512
    model = build_model(full)
    assert isinstance(model, EncDecLM)
    n = count_params(model.param_specs())
    assert n == jax_count_params(jax_build_model(jax_config(ARCH)).param_specs())
    assert 1.5e9 < n < 2.5e9
    with pytest.raises(ValueError, match="num_decoder_layers > 0"):
        dataclasses.replace(full, num_decoder_layers=0).validate()


def test_layernorm_matches_reference(jax_ref):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(48,)).astype(np.float32),
         "bias": rng.normal(size=(48,)).astype(np.float32)}
    ref = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-6)
    got = L.layernorm({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x), 1e-6)
    _close(got, ref, 1e-6)
    half = L.layernorm({k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x).to(torch.bfloat16), 1e-6)
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("t0,length,d", [(0, 64, 64), (37, 1, 64), (5, 30, 1024),
                                         (3000, 4, 1024)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_sinusoidal_positions_match_reference(t0, length, d, as_tensor, jax_ref):
    """``t0`` a Python int (prefill) or a 0-dim int32 tensor (a decode
    step's ``len``, read where it lives): the same table either way, within
    two float32 ulps of the largest angle of the reference's (an ulp of the
    frequency, from two libraries' ``exp``, moves the angle by up to that)."""
    atol = max(2e-6, 2 * float(np.spacing(np.float32(t0 + length))))
    ref = JL.sinusoidal_positions(jnp.asarray(t0, jnp.int32) if as_tensor else t0, length, d)
    start = torch.tensor(t0, dtype=torch.int32) if as_tensor else t0
    got = L.sinusoidal_positions(start, length, d)
    assert got.shape == (length, d) and got.dtype == torch.float32
    _close(got, ref, atol)
    assert torch.equal(got, L.sinusoidal_positions(t0, length, d))


def test_cross_attention_takes_memory_and_no_cache(pair):
    """``attention_block(xkv=...)``: K/V from the memory rows (here 7, the
    queries 3), never causal, no rope: equal to the reference's."""
    cfg_j, params_j, cfg_t, params_t = pair
    pj = jax.tree_util.tree_map(lambda a: a[0], params_j["dec_blocks"]["cross_attn"])
    pt = {k: v[0] for k, v in params_t["dec_blocks"]["cross_attn"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, cfg_t.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 7, cfg_t.d_model)).astype(np.float32)
    oj, _, kvj = JL.attention_block(pj, jnp.asarray(x), cfg_j, xkv=jnp.asarray(mem),
                                    use_rope=False)
    ot, none, kvt = L.attention_block(pt, torch.as_tensor(x), cfg_t, xkv=torch.as_tensor(mem),
                                      use_rope=False)
    assert none is None and kvt[0].shape == (2, 7, cfg_t.num_kv_heads, cfg_t.resolved_head_dim)
    _close(ot, oj)
    _close(kvt[0], kvj[0])
    with pytest.raises(ValueError, match="takes no cache"):
        L.attention_block(pt, torch.as_tensor(x), cfg_t, xkv=torch.as_tensor(mem),
                          cache={"k": None, "v": None, "len": 0})


# ---------------------------------------------------------------------------
# EncDecLM against the JAX model


def test_encode_decode_seq_forward_and_loss_match_reference(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    model_j, model_t = jax_build_model(cfg_j), build_model(cfg_t)
    src, tokens = _frames(4, 2, 9), _tokens(5, (2, 13))
    mem_j = model_j.encode(params_j, jnp.asarray(src))
    mem_t = model_t.encode(params_t, src)
    _close(mem_t, mem_j)
    _close(model_t.decode_seq(params_t, mem_t, torch.as_tensor(tokens), pos0=3),
           model_j.decode_seq(params_j, mem_j, jnp.asarray(tokens), pos0=3))
    ref = model_j.forward(params_j, {"src_embeds": jnp.asarray(src), "tokens": jnp.asarray(tokens)})
    got = model_t.forward(params_t, torch.as_tensor(tokens), src_embeds=torch.as_tensor(src))
    _close(got[..., :256], np.asarray(ref)[..., :256])
    labels = np.random.default_rng(6).integers(-1, 256, (2, 13)).astype(np.int32)
    loss_j = float(model_j.loss(params_j, {"src_embeds": jnp.asarray(src),
                                           "tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)}))
    loss_t = float(model_t.loss(params_t, {"src_embeds": torch.as_tensor(src),
                                           "tokens": torch.as_tensor(tokens),
                                           "labels": torch.as_tensor(labels)}))
    assert loss_t == pytest.approx(loss_j, rel=1e-5)


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and the self / cross caches, then five decode steps
    (each attends to the cached cross K/V)."""
    cfg_j, params_j, cfg_t, params_t = pair
    model_j, model_t = jax_build_model(cfg_j), build_model(cfg_t)
    src, tokens = _frames(7, 2), _tokens(8, (2, 11))
    lj, cj = model_j.prefill(params_j, jnp.asarray(tokens), MAX_LEN, src_embeds=jnp.asarray(src))
    lt, ct = model_t.prefill(params_t, torch.as_tensor(tokens), MAX_LEN, src_embeds=src)
    _close(lt[..., :256], np.asarray(lj)[..., :256])
    spec = dict(_leaves(model_j.cache_spec(2, MAX_LEN, src_len=SRC)))
    got = dict(_leaves(ct))
    assert sorted(got) == sorted(spec)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == spec[path].shape, path
        assert leaf.dtype == getattr(torch, np.dtype(spec[path].dtype).name), path
    nxt = tokens[:, -1:]
    for _ in range(5):
        lj, cj = model_j.decode_step(params_j, cj, jnp.asarray(nxt))
        lt, ct = model_t.decode_step(params_t, ct, torch.as_tensor(nxt))
        _close(lt[..., :256], np.asarray(lj)[..., :256])
        assert int(ct["len"]) == int(cj["len"])
        nxt = np.asarray(jnp.argmax(lj[..., :256], axis=-1)).astype(np.int32)
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, cj)))
    for path, leaf in got.items():
        _close(leaf, ref[path])


def test_decode_step_updates_the_cache_in_place(pair):
    """The step returns the cache it was given: the self K/V rows at ``len``
    and ``len`` itself rewritten in place, the cross K/V untouched."""
    *_, cfg_t, params_t = pair
    model = build_model(cfg_t)
    _, cache = model.prefill(params_t, torch.as_tensor(_tokens(9, (2, 6))), 16,
                             src_embeds=_frames(10, 2))
    before = {path: (leaf.data_ptr(), leaf.clone()) for path, leaf in _leaves(cache)}
    _, out = model.decode_step(params_t, cache, torch.as_tensor(_tokens(11, (2, 1))))
    assert out is cache
    for path, leaf in _leaves(out):
        ptr, old = before[path]
        assert leaf.data_ptr() == ptr, path
        assert torch.equal(leaf, old) == path.startswith("/cross"), path
    assert int(out["len"]) == 7
    assert not out["self"]["k"][:, :, 7:].any()  # only row 6 was written


def test_prefill_refuses_a_prompt_past_the_cache(pair):
    *_, cfg_t, params_t = pair
    with pytest.raises(ValueError, match="prefill length 9 exceeds cache capacity 8"):
        build_model(cfg_t).prefill(params_t, torch.as_tensor(_tokens(12, (1, 9))), 8,
                                   src_embeds=_frames(13, 1))


def test_compute_params_casts_the_encdec_projections_once():
    """In bfloat16 compute the frontend projection and every attention and
    MLP projection are cast once, the LayerNorm scales and biases stay
    float32, and the logits are bit for bit those of the uncast tree."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="bfloat16")
    model = build_model(cfg)
    params = materialize(model.param_specs(), 5, "cpu")
    cast = compute_params(params, cfg)
    assert cast["frontend_proj"]["kernel"].dtype == torch.bfloat16
    for part in ("attn", "mlp"):
        assert all(t.dtype == torch.bfloat16 for t in cast["enc_blocks"][part].values())
    for part in ("self_attn", "cross_attn", "mlp"):
        assert all(t.dtype == torch.bfloat16 for t in cast["dec_blocks"][part].values())
    for ln in ("ln1", "ln2", "ln3"):
        assert cast["dec_blocks"][ln]["bias"].dtype == torch.float32
    tokens, src = torch.as_tensor(_tokens(14, (2, 7))), torch.as_tensor(_frames(15, 2, 5))
    assert torch.equal(model.forward(cast, tokens, src_embeds=src),
                       model.forward(params, tokens, src_embeds=src))


# ---------------------------------------------------------------------------
# the lockstep engine


@pytest.mark.parametrize("batch,prompt,gen", [(2, 11, 7), (3, 4, 12)])
def test_lockstep_greedy_tokens_match_reference(batch, prompt, gen, pair):
    cfg_j, params_j, cfg_t, params_t = pair
    prompts, src = _tokens(batch, (batch, prompt)), _frames(batch + 20, batch)
    ref, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)).generate(
        jnp.asarray(prompts), gen, src_embeds=jnp.asarray(src))
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN), device="cpu")
        got, info_t = eng.generate(prompts, gen, src_embeds=src)
    assert got.dtype == torch.int32 and tuple(got.shape) == (batch, gen)
    assert got.tolist() == np.asarray(ref).tolist()
    assert info_t == info_j == {"cache_len": prompt + gen - 1}
    assert eng.graphs.entries() == 1


def test_lockstep_over_capacity_raises_where_the_reference_clamps(pair):
    """A prompt of 8 and 6 new tokens need 13 self-cache rows; ``max_len``
    10 holds 10.  The reference's ``dynamic_update_slice`` clamps the last
    writes onto row 9 and generates without a word (its ``cache_len`` reads
    13, and its tokens part from those of a cache that fits); the port
    raises before the prefill."""
    cfg_j, params_j, cfg_t, params_t = pair
    prompts, src = _tokens(16, (1, 8)), _frames(17, 1)
    clamped, info = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=10)).generate(
        jnp.asarray(prompts), 6, src_embeds=jnp.asarray(src))
    fits, _ = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)).generate(
        jnp.asarray(prompts), 6, src_embeds=jnp.asarray(src))
    assert info["cache_len"] == 13 > 10 and clamped.shape == (1, 6)
    assert not np.array_equal(np.asarray(clamped), np.asarray(fits))
    eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=10), device="cpu")
    eng.model.prefill = None  # the refusal comes before any prefill
    with pytest.raises(ValueError, match="needs 13 cache rows"):
        eng.generate(prompts, 6, src_embeds=src)
    got, _ = ServeEngine(cfg_t, params_t, ServeConfig(max_len=10), device="cpu").generate(
        prompts, 3, src_embeds=src)  # 10 rows fit
    np.testing.assert_array_equal(got.numpy(), np.asarray(fits)[:, :3])


def _no_host_read(*args, **kwargs):
    raise AssertionError("host read or upload during capture")


class NoHostReadGraph:
    """A stand-in capture object: the step records once with
    ``Tensor.item`` / ``tolist``, ``torch.cuda.synchronize`` and uploads of
    host data (``torch.tensor``, ``torch.as_tensor`` of a non-tensor) made to
    raise: what a CUDA graph cannot capture."""

    def __init__(self, device, stream):
        pass

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        real_as_tensor = torch.as_tensor

        def as_tensor(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                _no_host_read()
            return real_as_tensor(data, *args, **kwargs)

        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(torch.Tensor, "item", _no_host_read)
            mp.setattr(torch.Tensor, "tolist", _no_host_read)
            mp.setattr(torch.cuda, "synchronize", _no_host_read)
            mp.setattr(torch, "tensor", _no_host_read)
            mp.setattr(torch, "as_tensor", as_tensor)
            self.outputs = fn()
        finally:
            mp.undo()

    def replay(self):
        return self.outputs


def test_decode_step_captures_without_host_reads(monkeypatch, pair):
    """The lockstep step (the sinusoidal position from the device ``len``,
    the self-cache write, cross-attention over the cached K/V, the STAR
    sampling softmax at temperature 0.8) records through a stand-in capture
    with ``Tensor.item``, ``torch.cuda.synchronize`` and host uploads
    raising; its first replay serves the eager step's tokens."""
    *_, cfg_t, params_t = pair
    prompts, src = _tokens(18, (2, 9)), _frames(19, 2)
    sc = ServeConfig(max_len=MAX_LEN, temperature=0.8)
    with ops.use(softmax="pallas"):
        want, _ = ServeEngine(cfg_t, params_t, sc, device="cpu", seed=4).generate(
            prompts, 4, src_embeds=src)
        monkeypatch.setattr(engine_mod, "StepGraphs", lambda dev: graph_mod.StepGraphs(
            dev, graph_factory=NoHostReadGraph))
        eng = ServeEngine(cfg_t, params_t, sc, device="cpu", seed=4)
        state = eng.begin(prompts, src_embeds=src)
        first = eng.decode(state)
    assert eng.graphs.entries() == 1
    assert torch.equal(first, want[:, 1])


def test_continuous_engine_refuses_the_encdec_family(pair):
    *_, cfg_t, params_t = pair
    with pytest.raises(ValueError, match="attention-family"):
        ContinuousBatchingEngine(cfg_t, params_t, device="cpu")
    with pytest.raises(ValueError, match="attention-family"):
        launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine", "continuous"])


def test_launcher_serves_seamless_with_stub_frames(capsys):
    rng = np.random.default_rng(0)
    kw = launcher._frontend_kwargs(get_config(ARCH), rng, 3)
    assert kw["src_embeds"].shape == (3, 64, 1024) and kw["src_embeds"].dtype == np.float32
    rc = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "10", "--gen", "6", "--softmax-impl", "pallas",
                        "--attn-impl", "pallas"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "generated (2, 6)" in out and "cache_len=15" in out


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_encdec_smoke_lockstep_on_card_equals_cpu(cuda):
    """The smoke config's greedy lockstep tokens (float32: flash_star's tf32
    kernel at D 16, 6 launches a prefill: 2 encoder, 2 self, 2 cross; 4 a
    step: 2 self, 2 cross) on the card equal the CPU's."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    prompts, src = _tokens(50, (3, 12)), _frames(51, 3)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else tree_map(lambda t: t.cuda(), params)
        before = flash_mod.LAUNCHES.count
        eng = ServeEngine(cfg, p, ServeConfig(max_len=MAX_LEN), device=dev)
        outs[dev] = eng.generate(prompts, 10, src_embeds=src)[0].cpu().tolist()
        if dev == "cuda":
            assert flash_mod.LAUNCHES.count - before == 6 + 4 * 9
    assert outs["cpu"] == outs["cuda"]
