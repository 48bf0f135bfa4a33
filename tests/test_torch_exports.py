"""The reference's last public helpers, held against the JAX package.

* ``repro_torch.core`` exports the reference's 27 names, the same objects
  as its submodules, and imports first in a fresh interpreter (as do the
  modules it reaches through ``hwmodel.faults``);
* ``models.param.shape_tree`` / ``train.state.state_shapes`` give the
  reference's shapes and dtypes as ``meta`` tensors; ``cast_tree`` casts
  floating leaves only;
* ``kernels/star_softmax/ref.py`` against the reference's ``ref.py``;
  ``DEFAULT_BLOCK_K``, ``KV_DTYPES``, ``cross_entropy`` where the reference
  has them;
* ``spec_rmsnorm(dim)`` / ``spec_layernorm(dim)`` / ``spec_mlp(d_ff)`` and
  ``attention_block(kv_valid_len)`` against the reference;
* the continuous engine's ``on_token`` / ``metrics`` / ``clock``, with the
  values ``tests/test_serve.py`` and ``tests/test_obs_serve.py`` assert of
  the reference;
* ``launch.serve.run_continuous`` is the launcher's continuous branch.
"""

import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_star import kernel as jflash
from repro.kernels.star_softmax import ref as jsoft_ref
from repro.models import layers as JL
from repro.models import param as jparam
from repro.models.registry import build_model as jax_build_model
from repro.models.transformer import cross_entropy as jax_cross_entropy
from repro.serve import paged as jpaged
from repro.train import state as jstate
from repro_torch import core as tcore
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_star import kernel as tflash
from repro_torch.kernels.star_softmax import kernel as tsoft
from repro_torch.kernels.star_softmax import ref as tsoft_ref
from repro_torch.launch import serve as launcher
from repro_torch.models import layers as TL
from repro_torch.models import param as tparam
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import build_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import paged as tpaged
from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig
from repro_torch.train import state as tstate

ROOT = Path(__file__).resolve().parents[1]
CORE_NAMES = sorted(n for n in vars(jcore) if not n.startswith("_")
                    and not inspect.ismodule(getattr(jcore, n)))


# ---------------------------------------------------------------------------
# repro_torch.core


def test_core_exports_the_reference_names_from_their_modules():
    assert len(CORE_NAMES) == 27
    for name in CORE_NAMES:
        got = getattr(tcore, name)
        home = getattr(jcore, name).__module__.replace("repro.", "repro_torch.", 1)
        if inspect.isfunction(got) or inspect.isclass(got):
            assert got.__module__ == home, name
        assert got is getattr(sys.modules[home], name), name
    # the package's ``attention`` is the function, as in the reference
    assert tcore.attention is sys.modules["repro_torch.core.attention"].attention
    assert tcore.EXACT_SOFTMAX == tcore.SoftmaxConfig(kind="exact")
    assert tcore.EXACT_SOFTMAX.kind == jcore.EXACT_SOFTMAX.kind == "exact"
    assert tcore.STAR_SOFTMAX.kind == jcore.STAR_SOFTMAX.kind == "star"


def test_exact_softmax_config_matches_the_reference_attention():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 9, 4, 16)).astype(np.float32) for _ in range(3))
    got = tcore.attention(*map(torch.from_numpy, (q, k, v)), softmax=tcore.EXACT_SOFTMAX,
                          causal=True)
    want = jcore.attention(*map(jnp.asarray, (q, k, v)), softmax=jcore.EXACT_SOFTMAX,
                           causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("module", [
    "repro_torch.core", "repro_torch.hwmodel.faults", "repro_torch.models.layers",
    "repro_torch.kernels.paged_attention.ref", "repro_torch.kernels.star_softmax.ref",
    "repro_torch.core.star_softmax"])
def test_imports_first_in_a_fresh_interpreter(module):
    code = f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); import {module}"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# models.param / train.state


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _same_shapes(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].device.type == "meta", path
        assert tuple(g[path].shape) == tuple(w[path].shape), path
        assert str(g[path].dtype).replace("torch.", "") == str(w[path].dtype), path


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_130m", "bert_base_star"])
def test_shape_tree_and_state_shapes_match_the_reference(arch):
    specs_t = build_model(get_smoke_config(arch)).param_specs()
    specs_j = jax_build_model(jax_smoke_config(arch)).param_specs()
    _same_shapes(tparam.shape_tree(specs_t), jparam.shape_tree(specs_j))
    _same_shapes(tstate.state_shapes(specs_t), jstate.state_shapes(specs_j))


def test_cast_tree_casts_floating_leaves_only():
    tree = {"a": np.ones((2, 3), np.float32), "b": {"c": np.arange(4, dtype=np.int32),
                                                     "d": np.zeros((1,), np.float16)}}
    got = tparam.cast_tree({"a": torch.from_numpy(tree["a"]),
                            "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}},
                           torch.bfloat16)
    want = jparam.cast_tree(jax.tree_util.tree_map(jnp.asarray, tree), jnp.bfloat16)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# kernels, transformer, paged


@pytest.mark.parametrize("mode", ["gather", "onehot", "histogram"])
def test_star_softmax_ref_matches_the_reference_ref(mode):
    x = np.random.default_rng(1).standard_normal((6, 300)).astype(np.float32) * 4
    got = tsoft_ref.star_softmax_ref(torch.from_numpy(x), mode=mode)
    want = jsoft_ref.star_softmax_ref(jnp.asarray(x), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert tsoft.star_softmax_ref is tsoft_ref.star_softmax_ref


def test_exact_softmax_ref_matches_the_reference_ref():
    x = np.random.default_rng(2).standard_normal((5, 77)).astype(np.float32) * 3
    got = tsoft_ref.exact_softmax_ref(torch.from_numpy(x).to(torch.bfloat16))
    want = jsoft_ref.exact_softmax_ref(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_constants_and_re_exports_where_the_reference_has_them():
    assert tflash.DEFAULT_BLOCK_K == jflash.DEFAULT_BLOCK_K
    assert inspect.signature(tflash.flash_star_attention).parameters["block_k"].default == \
        tflash.DEFAULT_BLOCK_K
    assert tuple(tpaged.KV_DTYPES) == tuple(jpaged.KV_DTYPES)
    assert ttransformer.cross_entropy is TL.cross_entropy
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32)
    labels = rng.integers(-1, 33, (2, 7)).astype(np.int32)
    got = ttransformer.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# models.layers signatures


def test_spec_widths_match_the_reference():
    cfg_t, cfg_j = get_smoke_config("granite_8b"), jax_smoke_config("granite_8b")
    pairs = [(TL.spec_rmsnorm(cfg_t, 48), JL.spec_rmsnorm(cfg_j, 48)),
             (TL.spec_layernorm(cfg_t, 40), JL.spec_layernorm(cfg_j, 40)),
             (TL.spec_mlp(cfg_t, 96), JL.spec_mlp(cfg_j, 96)),
             (TL.spec_rmsnorm(cfg_t), JL.spec_rmsnorm(cfg_j)),
             (TL.spec_mlp(cfg_t), JL.spec_mlp(cfg_j))]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k in want:
            assert (got[k].shape, got[k].axes, got[k].init) == \
                (want[k].shape, want[k].axes, want[k].init)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_block_kv_valid_len_matches_the_reference(causal, cross):
    """A ragged batch without a cache: keys past each row's valid length
    are masked, as in the reference."""
    cfg_j, cfg_t = jax_smoke_config("granite_8b"), get_smoke_config("granite_8b")
    specs = jax_build_model(cfg_j).param_specs()["blocks"]["attn"]
    p_j = jax.tree_util.tree_map(lambda a: a[0], jparam.materialize(
        specs, jax.random.PRNGKey(1)))
    p_t = {k: torch.tensor(np.asarray(v)) for k, v in p_j.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg_t.d_model)).astype(np.float32)
    xkv = rng.standard_normal((2, 5, cfg_t.d_model)).astype(np.float32) if cross else None
    kvl = np.array([4, 2], np.int32)
    got, _, _ = TL.attention_block(
        p_t, torch.from_numpy(x), cfg_t, causal=causal, kv_valid_len=torch.from_numpy(kvl),
        xkv=None if xkv is None else torch.from_numpy(xkv))
    want, _, _ = JL.attention_block(
        p_j, jnp.asarray(x), cfg_j, causal=causal, kv_valid_len=jnp.asarray(kvl),
        xkv=None if xkv is None else jnp.asarray(xkv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    full, _, _ = TL.attention_block(p_t, torch.from_numpy(x), cfg_t, causal=causal,
                                    xkv=None if xkv is None else torch.from_numpy(xkv))
    assert not torch.allclose(got, full)  # the mask took effect


# ---------------------------------------------------------------------------
# the continuous engine's streaming, metrics and clock


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("granite_8b")
    return cfg, tparam.materialize(build_model(cfg).param_specs(), 0, "cpu")


def _hist(eng, name):
    (series,) = eng.metrics.snapshot()[name]["series"]
    return series["count"], series["sum"]


def test_lifecycle_metrics_deterministic_with_fake_clock(smoke):
    cfg, params = smoke
    clk, reg = FakeClock(), MetricsRegistry()
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(num_slots=2, max_len=40),
                                   device="cpu", clock=clk, metrics=reg)
    assert eng.metrics is reg
    eng.submit(np.arange(5), 3)  # t = 0
    clk.advance(1.0)
    eng.step()  # admit (queue wait 1.0), token 0 (TTFT 1.0), token 1 (ITL 0)
    clk.advance(0.5)
    eng.step()  # token 2 (ITL 0.5): the budget
    assert eng.scheduler.done()
    assert _hist(eng, "serve.queue_wait_s") == (1, pytest.approx(1.0))
    assert _hist(eng, "serve.ttft_s") == (1, pytest.approx(1.0))
    assert _hist(eng, "serve.itl_s") == (2, pytest.approx(0.5))
    assert reg.counter("serve.tokens.generated").value() == 3


def test_queue_wait_measures_backpressure(smoke):
    cfg, params = smoke
    clk = FakeClock()
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(num_slots=1, max_len=40),
                                   device="cpu", clock=clk)
    eng.submit(np.arange(4), 2)
    eng.submit(np.arange(1, 5), 2)
    while not eng.scheduler.done():
        clk.advance(1.0)
        eng.step()
    (series,) = eng.metrics.snapshot()["serve.queue_wait_s"]["series"]
    assert series["count"] == 2
    assert series["sum"] == pytest.approx(1.0 + 2.0)
    assert series["max"] == pytest.approx(2.0)


def test_continuous_streaming_events_and_slot_reuse(smoke):
    cfg, params = smoke
    events = []
    eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(num_slots=1, max_len=40),
                                   device="cpu", on_token=events.append)
    rng = np.random.default_rng(5)
    uids = [eng.submit(rng.integers(0, cfg.vocab_size, (4,)), 2) for _ in range(3)]
    done = eng.run()
    assert sorted(done) == sorted(uids)
    for uid in uids:
        mine = [e for e in events if e.uid == uid]
        assert [e.token for e in mine] == done[uid]
        assert [e.index for e in mine] == [0, 1]
        assert [e.finished for e in mine] == [False, True]


def test_launcher_continuous_branch_is_run_continuous(monkeypatch):
    calls = []
    monkeypatch.setattr(launcher, "run_continuous",
                        lambda args, cfg, params, device, max_len: calls.append(max_len) or 0)
    assert launcher.main(["--arch", "granite_8b", "--smoke", "--device", "cpu",
                          "--engine", "continuous", "--prompt-len", "6", "--gen", "3"]) == 0
    assert calls == [6 + 3 + 0 + 8]  # prompt + gen + patches + 8
