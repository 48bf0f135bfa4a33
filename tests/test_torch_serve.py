"""The port's continuous-batching engine against the JAX reference engine.

Same weights (through numpy), same config: ``attn_impl="pallas"`` (prefill
through flash_star, paged decode through ``pallas_paged``) and
``ops.use(softmax="pallas")``, paged KV at block size 4, 2 slots.  On the
CPU the port's kernel wrappers run their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.param import materialize as jax_materialize
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import ContinuousConfig as JaxConfig
from repro_torch import ops
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models.param import from_reference
from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

MAX_LEN = 40


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl="pallas")
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _engine(cfg_t, params_t, **kw):
    cb = ContinuousConfig(num_slots=2, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4,
                          **kw)
    return ContinuousBatchingEngine(cfg_t, params_t, cb, device="cpu")


def test_greedy_engine_token_identical_to_reference(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg_t.vocab_size, (n,)).astype(np.int32) for n in (5, 11, 8, 3)]
    gens = [4, 2, 5, 3]
    with jops.use(softmax="pallas"):
        eng_j = JaxEngine(cfg_j, params_j, JaxConfig(
            num_slots=2, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4))
        expected = eng_j.serve(prompts, gens)
    with ops.use(softmax="pallas"):
        eng_t = _engine(cfg_t, params_t)
        got = eng_t.serve(prompts, gens)
    assert got == expected
    assert eng_t.ticks == eng_j.ticks
    assert eng_t.kv_stats()["used_blocks"] == 0  # every block returned


def test_sampling_never_returns_a_padded_vocab_token(pair):
    """Smoke vocab 256 pads to 512; ``unembed`` masks the padding to -1e30.
    The reference's Pallas softmax wraps those columns to level 0 and
    samples them; the port saturates them to the last level."""
    _, _, cfg_t, params_t = pair
    assert cfg_t.padded_vocab > cfg_t.vocab_size
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg_t.vocab_size, (n,)) for n in (6, 9, 4, 12)]
    with ops.use(softmax="pallas"):
        out = _engine(cfg_t, params_t, temperature=0.8).serve(prompts, [12, 10, 14, 8])
    toks = [t for seq in out for t in seq]
    assert len(toks) == 44
    assert all(0 <= t < cfg_t.vocab_size for t in toks)


def test_sampling_probabilities_match_reference_softmax(pair):
    """The port's STAR sampling softmax (``pallas`` impl) over real
    prefill logits / T matches the reference's ``reference`` softmax."""
    cfg_j, _, cfg_t, params_t = pair
    eng = _engine(cfg_t, params_t)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(0, 256, (1, 10)))
    logits, _ = eng.model.prefill(params_t, tokens, 16)
    scaled = logits[0, -1].float() / 0.8
    with ops.use(softmax="pallas"):
        got = ops.softmax(scaled, cfg_t.softmax_spec).numpy()
    ref = np.asarray(jops.softmax(jnp.asarray(scaled.numpy()), cfg_j.softmax_spec,
                                  impl="reference"))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert got[cfg_t.vocab_size:].max() < 1e-27  # padded columns: last level


def test_seeded_sampling_is_reproducible_and_cotenant_independent(pair):
    _, _, cfg_t, params_t = pair
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg_t.vocab_size, (n,)) for n in (7, 5, 9)]
    with ops.use(softmax="pallas"):
        both = _engine(cfg_t, params_t, temperature=0.8).serve(prompts, [6, 6, 6])
        again = _engine(cfg_t, params_t, temperature=0.8).serve(prompts, [6, 6, 6])
        alone = _engine(cfg_t, params_t, temperature=0.8).serve(prompts[:1], [6])
    assert both == again
    assert both[0] == alone[0]


def test_pool_exhaustion_raises_instead_of_hanging(pair):
    """Exhaustion no longer raises: the engine preempts the latest-admitted
    request and drains with the tokens of an uncontended run.  A request no
    preemption could fit still raises, at submit, instead of hanging."""
    _, _, cfg_t, params_t = pair
    prompts, gens = [np.arange(7), np.arange(3, 10)], [6, 6]
    alone = [_engine(cfg_t, params_t).serve([p], [g])[0] for p, g in zip(prompts, gens)]
    eng = _engine(cfg_t, params_t, kv_pool_blocks=4)
    # 2 + 2 blocks at admission; the first decode append finds none free
    uids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    done = eng.run(max_ticks=20)
    assert [done[u] for u in uids] == alone
    assert eng.preemptions >= 1 and eng.kv_stats()["preemptions"] == eng.preemptions
    assert eng.block_pool.used_blocks == 0
    with pytest.raises(ValueError, match="raise kv_pool_blocks"):
        eng.submit(np.arange(12), 8)  # 19 rows: 5 blocks > the pool's 4


def test_engine_without_device_needs_cuda(pair, monkeypatch):
    _, _, cfg_t, params_t = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(num_slots=2, kv_layout="paged"))


def test_launcher_smoke_on_cpu(capsys):
    rc = launcher.main(["--arch", "granite_8b", "--smoke", "--device", "cpu",
                        "--engine", "continuous", "--kv-layout", "paged", "--attn-impl", "pallas",
                        "--softmax-impl", "pallas", "--temperature", "0.8",
                        "--requests", "3"])
    assert rc == 0
    assert "served 3 requests" in capsys.readouterr().out
