"""The hybrid family (recurrentgemma-2b: RG-LRU blocks beside local
attention) and flash_star at head_dim 256, against the JAX reference.

Weights and inputs come from seeds through numpy (``from_reference``).  The
JAX side keeps its default routes (attention ``xla``, softmax
``reference``); the port runs ``attn_impl="pallas"`` under
``ops.use(softmax="pallas")`` where the engine serves, so attention and
sampling go through the kernel wrappers, which run their plain versions on
the CPU.  The smoke config's window is 16, so prompts of 17 tokens and more
wrap its ring.  Tolerances: the RG-LRU scan at ``atol=2e-6`` (float32, the
doubling scan associates the products in another order than
``associative_scan``); blocks, logits and caches at ``atol=1e-4`` (float32
sums in another order); ``len`` and greedy tokens identical; the plain
flash_star against the JAX kernel in interpret mode at D 256 on dyadic
inputs (every score exact in any order) at ``atol=1e-5``.

The ``cuda`` tests hold flash_star's bf16 kernel at D 256 to its plain
version on the card, check that its D-256 instantiations spill nothing, and
hold the smoke config's lockstep tokens on the card to the CPU's; they skip
where there is no card.
"""

import dataclasses
import importlib
import re

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
from repro_torch.kernels import _cuda
from repro_torch.launch import serve as launcher
from repro_torch.models import rglru
from repro_torch.models.param import (
    compute_params,
    count_params,
    from_reference,
    layer,
    materialize,
    tree_map,
)
from repro_torch.models.registry import build_model
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graph as graph_mod
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeConfig, ServeEngine

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.fixedpoint import DEFAULT_FORMAT as JFMT
    from repro.kernels.flash_star.kernel import flash_star_attention as jax_flash
    from repro.models import rglru as jrglru
    from repro.models.param import count_params as jax_count_params
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro.serve.engine import ServeEngine as JaxServeEngine
except ImportError:
    jax = None

flash_mod = importlib.import_module("repro_torch.kernels.flash_star.kernel")
paged_mod = importlib.import_module("repro_torch.kernels.paged_attention.kernel")

ARCH = "recurrentgemma_2b"
ATOL = 1e-4  # blocks, logits, caches
SCAN_ATOL = 2e-6  # the RG-LRU scan, float32 in another association
KERNEL_ATOL = 1e-5  # the plain flash_star vs the JAX kernel on dyadic inputs
MAX_LEN = 64
D256 = 256


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


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 8.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the config


def test_configs_and_parameter_count_match_reference(jax_ref):
    assert ARCH in ARCH_IDS
    full = get_config(ARCH)
    for mine, ref in ((full, jax_config(ARCH)), (get_smoke_config(ARCH), jax_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            if f.name not in ("softmax", "attention"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert full.resolved_head_dim == D256 and full.num_heads // full.num_kv_heads == 10
    model = build_model(full)
    assert isinstance(model, rglru.RecurrentGemmaLM)
    assert (model.num_periods, model.tail) == (8, 2)
    n = count_params(model.param_specs())
    assert n == jax_count_params(jax_build_model(jax_config(ARCH)).param_specs())
    assert 3.0e9 < n < 4.0e9
    with pytest.raises(ValueError, match="block_pattern"):
        dataclasses.replace(full, block_pattern=()).validate()


# ---------------------------------------------------------------------------
# the RG-LRU scan and the two blocks


@pytest.mark.parametrize("t", [1, 7, 33])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_rglru_scan_matches_reference(t, with_h0, jax_ref):
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, 12)).astype(np.float32)
    a = rng.uniform(0.05, 0.999, size=(2, t, 12)).astype(np.float32)
    h0 = rng.normal(size=(2, 12)).astype(np.float32) if with_h0 else None
    hj, lj = jrglru.rglru_scan(jnp.asarray(x), jnp.asarray(a),
                               None if h0 is None else jnp.asarray(h0))
    ht, lt = rglru.rglru_scan(torch.as_tensor(x), torch.as_tensor(a),
                              None if h0 is None else torch.as_tensor(h0))
    _close(ht, hj, SCAN_ATOL)
    _close(lt, lj, SCAN_ATOL)
    # the serial recurrence it stands for
    h = np.zeros((2, 12), np.float64) if h0 is None else h0.astype(np.float64)
    for i in range(t):
        h = a[:, i] * h + np.sqrt(np.maximum(1 - a[:, i] ** 2, 1e-12)) * x[:, i]
        np.testing.assert_allclose(ht[:, i].numpy(), h, atol=SCAN_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_recurrent_block_matches_reference(mode, pair):
    cfg_j, params_j, cfg_t, params_t = pair
    bj = jax.tree_util.tree_map(lambda a: a[0], params_j["periods"]["b0"])
    bt = layer(params_t["periods"], 0)["b0"]
    rng = np.random.default_rng(7)
    t = 19 if mode == "prefill" else 1
    h = rng.normal(size=(2, t, cfg_t.d_model)).astype(np.float32)
    if mode == "prefill":
        oj, cj = jrglru.recurrent_block(bj, jnp.asarray(h), cfg_j, return_state=True)
        ot, ct = rglru.recurrent_block(bt, torch.as_tensor(h), cfg_t, return_state=True)
    else:
        w = cfg_t.lru_width
        conv = rng.normal(size=(2, cfg_t.conv_width - 1, w)).astype(np.float32)
        hs = rng.normal(size=(2, w)).astype(np.float32)
        oj, cj = jrglru.recurrent_block(bj, jnp.asarray(h), cfg_j,
                                        {"conv": jnp.asarray(conv), "h": jnp.asarray(hs)})
        ot, ct = rglru.recurrent_block(bt, torch.as_tensor(h), cfg_t,
                                       {"conv": torch.as_tensor(conv), "h": torch.as_tensor(hs)})
    _close(ot, oj)
    _close(ct["conv"], cj["conv"])
    _close(ct["h"], cj["h"])
    assert ct["h"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_local_attn_block_matches_reference(mode, pair):
    """Prefill over 21 rows (past the window of 16) and a ring step at len 21
    (row 21 % 16), its K/V row written in place."""
    cfg_j, params_j, cfg_t, params_t = pair
    bj = jax.tree_util.tree_map(lambda a: a[0], params_j["periods"]["b2"])
    bt = layer(params_t["periods"], 0)["b2"]
    rng = np.random.default_rng(8)
    if mode == "prefill":
        h = rng.normal(size=(2, 21, cfg_t.d_model)).astype(np.float32)
        oj, kvj = jrglru.local_attn_block(bj, jnp.asarray(h), cfg_j, return_kv=True)
        ot, kvt = rglru.local_attn_block(bt, torch.as_tensor(h), cfg_t)
        _close(ot, oj)
        for got, name in zip(kvt, ("k", "v")):
            _close(got, kvj[name])
        return
    h = rng.normal(size=(2, 1, cfg_t.d_model)).astype(np.float32)
    ring = (2, cfg_t.local_window, cfg_t.num_kv_heads, cfg_t.resolved_head_dim)
    k, v = (rng.normal(size=ring).astype(np.float32) for _ in range(2))
    oj, cj = jrglru.local_attn_block(bj, jnp.asarray(h), cfg_j,
                                     {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                     cache_len=jnp.asarray(21, jnp.int32))
    ck, cv = torch.as_tensor(k.copy()), torch.as_tensor(v.copy())
    ot, _ = rglru.local_attn_block(bt, torch.as_tensor(h), cfg_t,
                                   {"k": ck, "v": cv, "len": torch.tensor(21, dtype=torch.int32)})
    _close(ot, oj)
    _close(ck, cj["k"])
    _close(cv, cj["v"])
    assert not np.array_equal(ck.numpy(), k)  # the ring row was written in place


# ---------------------------------------------------------------------------
# RecurrentGemmaLM against the JAX model


def test_forward_and_loss_match_reference(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    model_j, model_t = jax_build_model(cfg_j), build_model(cfg_t)
    tokens = _tokens(3, (2, 27))
    labels = np.random.default_rng(4).integers(-1, 256, (2, 27)).astype(np.int32)
    ref = model_j.forward(params_j, jnp.asarray(tokens))
    got = model_t.forward(params_t, torch.as_tensor(tokens))
    _close(got[..., :256], np.asarray(ref)[..., :256])
    loss_j = float(model_j.loss(params_j, {"tokens": jnp.asarray(tokens),
                                           "labels": jnp.asarray(labels)}))
    loss_t = float(model_t.loss(params_t, {"tokens": torch.as_tensor(tokens),
                                           "labels": torch.as_tensor(labels)}))
    assert loss_t == pytest.approx(loss_j, rel=1e-5)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("prompt,max_len", [(23, 40), (9, 12)])
def test_prefill_and_decode_match_reference(prompt, max_len, pair):
    """Prefill logits and every cache leaf (conv windows, RG-LRU states,
    rings fitted by ``fit_window_cache``), then five decode steps: a prompt
    of 23 past the 16-row ring, and one of 9 in a ring of 12 rows
    (``max_len`` below the window), both wrapping as they decode."""
    cfg_j, params_j, cfg_t, params_t = pair
    model_j, model_t = jax_build_model(cfg_j), build_model(cfg_t)
    tokens = _tokens(prompt, (2, prompt))
    lj, cj = model_j.prefill(params_j, jnp.asarray(tokens), max_len)
    lt, ct = model_t.prefill(params_t, torch.as_tensor(tokens), max_len)
    _close(lt[..., :256], np.asarray(lj)[..., :256])
    spec = dict(_leaves(model_j.cache_spec(2, max_len)))
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
    """The step returns the cache it was given, every leaf the same tensor
    (the conv windows, RG-LRU states, rings and ``len`` rewritten in place):
    what a CUDA graph of the step needs."""
    *_, cfg_t, params_t = pair
    model = build_model(cfg_t)
    _, cache = model.prefill(params_t, torch.as_tensor(_tokens(5, (2, 18))), 32)
    before = {path: (leaf.data_ptr(), leaf.clone()) for path, leaf in _leaves(cache)}
    _, out = model.decode_step(params_t, cache, torch.as_tensor(_tokens(6, (2, 1))))
    assert out is cache
    for path, leaf in _leaves(out):
        ptr, old = before[path]
        assert leaf.data_ptr() == ptr, path
        assert not torch.equal(leaf, old), path  # every leaf moved
    assert int(out["len"]) == 19


# ---------------------------------------------------------------------------
# the weights the engines compute with


def test_compute_params_keeps_the_rglru_gates_float32():
    """In bfloat16 compute, ``compute_params`` casts an RG-LRU block's ``wx``
    / ``wgate`` / ``wout``, the MLP's ``wi`` and the attention projections
    once, and leaves the block's ``wa``, ``wi`` and ``lam`` float32 (the
    reference reads them in float32): logits from the cast tree are bit for
    bit those of the uncast tree, where a tree cast by leaf name (the RG-LRU
    ``wi`` in bf16) departs from them."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="bfloat16")
    model = build_model(cfg)
    params = materialize(model.param_specs(), 3, "cpu")
    cast = compute_params(params, cfg)
    for tree in (layer(cast["periods"], 0)["b0"], cast["tail1"]):
        assert tree["wa"].dtype == tree["wi"].dtype == tree["lam"].dtype == torch.float32
        assert tree["wx"].dtype == tree["wgate"].dtype == tree["wout"].dtype == torch.bfloat16
        assert tree["mlp"]["wi"].dtype == tree["conv"]["kernel"].dtype == torch.bfloat16
    attn = layer(cast["periods"], 0)["b2"]["attn"]
    assert all(attn[n].dtype == torch.bfloat16 for n in ("wq", "wk", "wv", "wo"))
    tokens = torch.as_tensor(_tokens(11, (2, 20)))
    want = model.forward(params, tokens)
    assert torch.equal(model.forward(cast, tokens), want)
    lp, cp = model.prefill(params, tokens, 24)
    lc, cc = model.prefill(cast, tokens, 24)
    assert torch.equal(lp, lc)
    nxt = tokens[:, -1:]
    assert torch.equal(model.decode_step(params, cp, nxt)[0], model.decode_step(cast, cc, nxt)[0])
    by_name = tree_map(lambda t: t, cast)
    for block in (by_name["tail0"], by_name["tail1"]):
        block["wi"] = block["wi"].to(torch.bfloat16)
    assert not torch.equal(model.forward(by_name, tokens), want)
    eng = ServeEngine(cfg, params, ServeConfig(max_len=32), device="cpu")
    assert eng.params["tail0"]["wi"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the lockstep engine


@pytest.mark.parametrize("batch,prompt,gen", [(2, 21, 8), (3, 17, 12), (1, 9, 20)])
def test_lockstep_greedy_tokens_match_reference(batch, prompt, gen, pair):
    """Prompts past the window of 16 (the ring wraps at prefill) and one
    whose decode wraps it."""
    cfg_j, params_j, cfg_t, params_t = pair
    prompts = _tokens(batch, (batch, prompt))
    ref, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)).generate(
        jnp.asarray(prompts), gen)
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN), device="cpu")
        got, info_t = eng.generate(prompts, gen)
    assert got.dtype == torch.int32 and tuple(got.shape) == (batch, gen)
    assert got.tolist() == np.asarray(ref).tolist()
    assert info_t == info_j == {"cache_len": prompt + gen - 1}
    assert eng.graphs.entries() == 1


def test_short_ring_below_the_window_matches_reference(pair):
    """``max_len`` 12 < ``local_window`` 16: the hybrid's rings hold 12 rows
    (``min(max_len, local_window)``), so once 12 tokens are cached decode
    attends to the last 12, not 16 (ROADMAP C, properties of the reference).
    The port matches the reference in both: the tokens with 12 rows equal
    the reference's, and part from those of rings of 16 rows."""
    cfg_j, params_j, cfg_t, params_t = pair
    prompts = _tokens(30, (2, 10))
    outs = {}
    for max_len in (12, MAX_LEN):
        ref, _ = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=max_len)).generate(
            jnp.asarray(prompts), 16)
        got, info = ServeEngine(cfg_t, params_t, ServeConfig(max_len=max_len),
                                device="cpu").generate(prompts, 16)
        assert got.tolist() == np.asarray(ref).tolist()
        assert info == {"cache_len": 25}  # past the 12 rows: no refusal, the ring wraps
        outs[max_len] = got.tolist()
    assert outs[12] != outs[MAX_LEN]
    assert build_model(cfg_t).cache_len(12) == 12


def test_lockstep_sampling_stays_in_vocab_and_is_seeded(pair):
    *_, cfg_t, params_t = pair
    prompts = _tokens(9, (3, 18))
    sc = ServeConfig(max_len=MAX_LEN, temperature=0.8)
    with ops.use(softmax="pallas"):
        outs = [ServeEngine(cfg_t, params_t, sc, device="cpu", seed=s).generate(prompts, 8)[0]
                for s in (1, 1, 2)]
    assert all(((o >= 0) & (o < cfg_t.vocab_size)).all() for o in outs)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


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
    """The lockstep step (the RG-LRU step, the ring write at ``len % T``, the
    STAR sampling softmax at temperature 0.8) records through a stand-in
    capture with ``Tensor.item``, ``torch.cuda.synchronize`` and host
    uploads raising, and its replays serve the same tokens as eager steps."""
    *_, cfg_t, params_t = pair
    prompts = _tokens(12, (2, 20))
    sc = ServeConfig(max_len=MAX_LEN, temperature=0.8)
    with ops.use(softmax="pallas"):
        want, _ = ServeEngine(cfg_t, params_t, sc, device="cpu", seed=4).generate(prompts, 6)
        monkeypatch.setattr(engine_mod, "StepGraphs", lambda dev: graph_mod.StepGraphs(
            dev, graph_factory=NoHostReadGraph))
        eng = ServeEngine(cfg_t, params_t, sc, device="cpu", seed=4)
        state = eng.begin(prompts)
        outs = [state.tokens[:, 0].clone()] + [eng.decode(state) for _ in range(5)]
    assert eng.graphs.entries() == 1
    # the stand-in replays the recorded outputs: the first step's tokens
    assert torch.equal(outs[1], want[:, 1])


def test_continuous_engine_refuses_the_hybrid(pair, capsys):
    *_, cfg_t, params_t = pair
    with pytest.raises(ValueError, match="attention-family"):
        ContinuousBatchingEngine(cfg_t, params_t, device="cpu")
    with pytest.raises(ValueError, match="attention-family"):
        launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine", "continuous"])


def test_launcher_serves_recurrentgemma(capsys):
    rc = launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "20", "--gen", "6", "--softmax-impl", "pallas",
                        "--attn-impl", "pallas"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "generated (2, 6)" in out and "cache_len=25" in out


# ---------------------------------------------------------------------------
# flash_star at D 256: the plain version, the wrapper's routing and refusals

FLASH_D256_CASES = [
    # b, hq, hkv, tq, tk, causal, window, q_offset, kv_valid
    (1, 10, 1, 40, 40, True, 16, 0, None),       # recurrentgemma's MQA group of 10, a window
    (2, 10, 1, 1, 37, False, None, 0, (37, 9)),  # a ring step (Tq = 1)
    (1, 4, 2, 17, 33, True, None, 16, (30,)),    # q_offset, ragged
]


@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
@pytest.mark.parametrize("case", FLASH_D256_CASES)
def test_flash_star_plain_matches_pallas_at_d256(case, star, jax_ref):
    b, hq, hkv, tq, tk, causal, window, q_off, kvl = case
    rng = np.random.default_rng(41)
    q, k, v = (_dyadic(rng, sh) for sh in ((b, hq, tq, D256), (b, hkv, tk, D256),
                                          (b, hkv, tk, D256)))
    info = np.array([q_off] + list(kvl or [tk] * b), np.int32)
    ref = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(info),
        fmt=JFMT if star else None, causal=causal, sliding_window=window,
        block_q=16, block_k=16, interpret=True))
    got = flash_mod.flash_star_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(info),
        fmt=FMT if star else None, causal=causal, sliding_window=window, block_k=16)
    np.testing.assert_allclose(got.numpy(), ref, atol=KERNEL_ATOL, rtol=0)


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


def test_flash_star_wrapper_routes_d256_to_the_bf16_kernel_only(monkeypatch):
    """D 256 on every kernel (the name predates the float32 and int8 P.V
    kernels at D 256): bf16 q/k/v reach ``flash_star_mma_launch`` and
    float32 ``flash_star_tf32_launch``, with D 256 (the ops layer's
    transposed views); ``pv_int8`` at D 256 with ``block_k`` 256 reaches
    the V pre-pass and the int8 P.V launch with bk 256, either type; the
    paged wrapper hands D 256 over fp pages to ``paged_attention_launch``
    and over int8 / fp8 codes to ``paged_attention_quant_launch``."""
    lib = _fake(monkeypatch, flash_mod, (
        "flash_star_mma_launch", "flash_star_tf32_launch", "flash_star_quantize_v_launch",
        "flash_star_pv_int8_launch"))
    g = torch.Generator().manual_seed(44)
    info = torch.tensor([0, 300], dtype=torch.int32)

    def views(dtype):
        return [torch.randn(sh, generator=g).to(dtype).transpose(1, 2)
                for sh in ((1, 300, 10, D256), (1, 300, 1, D256), (1, 300, 1, D256))]

    for dtype, entry in ((torch.bfloat16, "flash_star_mma_launch"),
                         (torch.float32, "flash_star_tf32_launch")):
        before = flash_mod.LAUNCHES.count
        out = flash_mod.flash_star_attention(*views(dtype), info, fmt=FMT, sliding_window=2048)
        assert out.shape == (1, 10, 300, D256) and out.dtype == dtype
        assert [name for name, _ in lib.calls] == [entry]
        assert lib.calls[0][1][18:24] == (1, 10, 1, 300, 300, D256)  # B Hq Hkv Tq Tk D
        assert lib.calls[0][1][24:26] == (1, 2048)  # causal, window
        assert flash_mod.LAUNCHES.count == before + 1
        lib.calls.clear()
    for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        before = flash_mod.PV_INT8_LAUNCHES.count
        out = flash_mod.flash_star_attention(*views(dtype), info, fmt=FMT, block_k=256,
                                             pv_int8=True)
        assert out.shape == (1, 10, 300, D256) and out.dtype == dtype
        assert [name for name, _ in lib.calls] == ["flash_star_quantize_v_launch",
                                                   "flash_star_pv_int8_launch"]
        assert lib.calls[0][1][4:10] == (1, 1, 300, D256, code, 256)  # B Hkv Tk D dtype bk
        pv = lib.calls[1][1]
        assert pv[18:24] == (1, 10, 1, 300, 300, D256) and pv[24] == code and pv[30] == 256
        assert flash_mod.PV_INT8_LAUNCHES.count == before + 1
        lib.calls.clear()
    plib = _fake(monkeypatch, paged_mod, ("paged_attention_launch",
                                          "paged_attention_quant_launch"))
    q = torch.zeros(2, 10, D256, dtype=torch.bfloat16)
    tables, kvl = torch.ones(2, 2, dtype=torch.int32), torch.tensor([3, 4], dtype=torch.int32)
    pages = torch.zeros(5, 16, 1, D256, dtype=torch.bfloat16)
    out = paged_mod.paged_flash_attention(q, pages, pages, tables, kvl, fmt=FMT)
    assert out.shape == (2, 10, D256)
    codes = torch.zeros(5, 16, 1, D256, dtype=torch.int8)
    scale = torch.ones(5, 1)
    paged_mod.paged_flash_attention(q, codes, codes, tables, kvl, fmt=FMT, k_scale=scale,
                                    v_scale=scale)
    assert [name for name, _ in plib.calls] == ["paged_attention_launch",
                                                "paged_attention_quant_launch"]
    assert plib.calls[0][1][7:14] == (2, 10, 1, 2, 16, D256, 1)  # S Hq Hkv W bs D dtype
    assert plib.calls[1][1][9:17] == (2, 10, 1, 2, 16, D256, 1, 0)  # ... code


def test_source_dispatches_d256_to_the_bf16_kernel_only():
    """Every kernel's dispatch takes D 256 (the name predates the float32 and
    int8 P.V kernels at D 256): flash_star's ``case 256`` for every kind
    (the bf16 kernel with Q's fragments from shared memory and 32-row KV
    tiles; the float32 and int8 P.V kernels at 32 q rows a CTA, two warps a
    row group), the V pre-pass up to D 256, the paged kernel's ``case
    256`` with 8 P.V columns a thread."""
    src = flash_mod.SOURCE.read_text()
    assert D256 in flash_mod.HEAD_DIMS and D256 in paged_mod.HEAD_DIMS
    case = src[src.index("case 256:"):src.index("default: return cudaErrorInvalidValue;")]
    assert "launch_kind<KIND, true, 256>" in case and "if constexpr" not in case
    assert "constexpr bool Q_SMEM = D > 128;" in src
    assert "constexpr int mk_of(int d) { return d > 128 ? 32 : 64; }" in src  # 0 spills
    assert "if (Q_SMEM && step % (NS / 2) == 0) ldsm_x4(qa[0], qfrag + 16 * kk);" in src
    assert "static constexpr int MQ = WIDE ? 32 : 64;" in src
    assert "D > QV_MAX_D" in src and "constexpr int QV_MAX_D = 256;" in src
    psrc = paged_mod.SOURCE.read_text()
    assert "case 256: return launch<T, C, 256, STAR>(p, stream);" in psrc
    assert "return d > 128 ? 8 : 4;" in psrc


# ---------------------------------------------------------------------------
# on the card

CARD_D256 = FLASH_D256_CASES + [
    (1, 10, 1, 300, 300, True, 128, 0, None),          # across 64-row tiles, a window
    (4, 10, 1, 1, 520, False, None, 0, (520, 300, 64, 1)),  # ring steps, ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("star", [True, False], ids=["star", "exact"])
def test_flash_star_kernel_at_d256_matches_plain_on_card(cuda, star):
    """Dyadic operands (every score exact in any order): the bf16 kernel at
    D 256 (Q's fragments from shared memory) against the plain version,
    heads-major and as transposed views, one launch a call; bf16 outputs
    within two bf16 ulps (both round one float32 value after sums in
    another order)."""
    rng = np.random.default_rng(45)
    for b, hq, hkv, tq, tk, causal, window, q_off, kvl in CARD_D256:
        for transposed in (False, True):
            shapes = ((b, hq, tq, D256), (b, hkv, tk, D256), (b, hkv, tk, D256))
            if transposed:
                shapes = [(sh[0], sh[2], sh[1], sh[3]) for sh in shapes]
            q, k, v = (torch.as_tensor(_dyadic(rng, sh), device=cuda).to(torch.bfloat16)
                       for sh in shapes)
            if transposed:
                q, k, v = (x.transpose(1, 2) for x in (q, k, v))
            info = torch.tensor([q_off] + list(kvl or [tk] * b), dtype=torch.int32, device=cuda)
            kw = dict(fmt=FMT if star else None, causal=causal, sliding_window=window)
            before = flash_mod.LAUNCHES.count
            got = flash_mod.flash_star_attention(q, k, v, info, **kw)
            assert flash_mod.LAUNCHES.count == before + 1
            ref = flash_mod.flash_star_ref(q, k, v, info, **kw)
            torch.testing.assert_close(got.float(), ref.float(), atol=8e-3, rtol=8e-3)


@pytest.mark.cuda
def test_flash_star_d256_instantiations_spill_nothing(cuda):
    """ptxas's lines for the two D-256 instantiations (STAR, exact) of the
    bf16 kernel: 0 bytes of spill stores and loads."""
    log = _cuda.build([flash_mod.SOURCE])[flash_mod.SOURCE]
    found, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
        elif cur and "flash_star_mma_kernelILi256E" in cur and "spill" in line:
            found[cur] = line
    assert len(found) == 2, found
    assert all("0 bytes spill stores, 0 bytes spill loads" in x for x in found.values()), found


@pytest.mark.cuda
def test_hybrid_smoke_lockstep_on_card_equals_cpu(cuda):
    """The smoke config's greedy lockstep tokens (float32: flash_star's
    tf32 kernel at D 16, once per attention layer of the prefill and of each
    replay) on the card equal the CPU's."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), attn_impl="pallas")
    params = materialize(build_model(cfg).param_specs(), 0, "cpu")
    prompts = _tokens(50, (3, 22))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else tree_map(lambda t: t.cuda(), params)
        before = flash_mod.LAUNCHES.count
        eng = ServeEngine(cfg, p, ServeConfig(max_len=MAX_LEN), device=dev)
        outs[dev] = eng.generate(prompts, 10)[0].cpu().tolist()
        if dev == "cuda":
            assert flash_mod.LAUNCHES.count - before == 10
    assert outs["cpu"] == outs["cuda"]
