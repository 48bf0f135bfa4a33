"""The dense per-slot KV layout, the lockstep engine for attention models and
sliding-window rings, against the JAX reference with the same weights.

The granite-8b smoke config with ``attn_impl="pallas"`` in both packages
(the reference's flash_star and paged kernels in Pallas interpret mode; the
port's kernel wrappers run their plain versions on the CPU), weights carried
by ``models.param.from_reference``, 2 slots, ``max_len`` 40.  KV rows and
logits hold to ``atol=1e-4`` at float32 (float32 rounding of sums taken in
another order); greedy tokens are identical.  Rings set
``sliding_window=16`` on both configs with ``dataclasses.replace``.
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
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import ops
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models.param import from_reference
from repro_torch.models.registry import build_model
from repro_torch.ops import impls
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import graph as graph_mod
from repro_torch.serve.engine import (
    ContinuousBatchingEngine,
    ContinuousConfig,
    ServeConfig,
    ServeEngine,
)

ATOL = 1e-4
MAX_LEN = 40
WINDOW = 16


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl="pallas")
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                              device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _windowed(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    return (dataclasses.replace(cfg_j, sliding_window=WINDOW), params_j,
            dataclasses.replace(cfg_t, sliding_window=WINDOW), params_t)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _serve_both(pair, prompts, gens, **kw):
    """The same greedy workload through the JAX engine and the port's."""
    cfg_j, params_j, cfg_t, params_t = pair
    with jops.use(softmax="pallas"):
        want = JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN, **kw)
                         ).serve(prompts, gens)
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, **kw), device="cpu")
        got = eng.serve(prompts, gens)
    return got, want, eng


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the model: pool, slot writes, decode steps


def test_pool_cache_write_reset_and_per_slot_decode_match_jax(pair):
    """Two ragged prompts written into a 3-slot dense pool (slot 2 free),
    three per-slot decode steps: the KV rows, the logits of the live slots
    and the counters as in the reference; ``reset_slot`` zeroes a slot's
    counters and leaves its rows."""
    cfg_j, params_j, cfg_t, params_t = pair
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    pool_j = mj.init_pool_cache(3, MAX_LEN)
    pool_t = mt.init_pool_cache(3, MAX_LEN, device="cpu")
    assert tuple(pool_t["layers"]["k"].shape) == tuple(pool_j["layers"]["k"].shape)
    for slot, prompt in enumerate(_prompts(5, (5, 11))):
        _, c_j = mj.prefill(params_j, jnp.asarray(prompt)[None], MAX_LEN)
        _, c_t = mt.prefill(params_t, torch.as_tensor(prompt)[None], MAX_LEN)
        pool_j = mj.write_slot(pool_j, c_j, slot)
        assert mt.write_slot(pool_t, c_t, slot) is pool_t
    rng = np.random.default_rng(6)
    step_j = jax.jit(mj.decode_step)
    for _ in range(3):
        tok = rng.integers(0, 256, (3, 1)).astype(np.int32)
        lg_j, pool_j = step_j(params_j, pool_j, jnp.asarray(tok))
        lg_t, out = mt.decode_step(params_t, pool_t, torch.as_tensor(tok))
        assert out is pool_t
        _close(lg_t[:2], lg_j[:2])  # slot 2 is free: its output is discarded
    for name in ("k", "v"):
        _close(pool_t["layers"][name], pool_j["layers"][name])
    for name in ("len", "pos"):
        np.testing.assert_array_equal(pool_t[name].numpy(), np.asarray(pool_j[name]))
    assert pool_t["len"].tolist() == [8, 14, 3]
    k_before = pool_t["layers"]["k"].clone()
    mt.reset_slot(pool_t, 1)
    pool_j = mj.reset_slot(pool_j, 1)
    for name in ("len", "pos"):
        np.testing.assert_array_equal(pool_t[name].numpy(), np.asarray(pool_j[name]))
    assert torch.equal(pool_t["layers"]["k"], k_before)
    with pytest.raises(ValueError, match="pool's max_len"):
        _, short = mt.prefill(params_t, torch.as_tensor(_prompts(1, (4,))[0])[None], 16)
        mt.write_slot(pool_t, short, 0)


@pytest.mark.parametrize("window", [None, WINDOW], ids=["linear", "ring"])
def test_scalar_decode_steps_match_jax(pair, window):
    """The lockstep cache (scalar ``len``): a batch-2 prefill, then decode
    steps written at the device ``len`` (a ring: ``len % T``, past its first
    lap), KV rows and logits as in the reference."""
    cfg_j, params_j, cfg_t, params_t = pair if window is None else _windowed(pair)
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    prompts = np.stack(_prompts(7, (12, 12)))
    lg_j, c_j = mj.prefill(params_j, jnp.asarray(prompts), MAX_LEN)
    lg_t, c_t = mt.prefill(params_t, torch.as_tensor(prompts), MAX_LEN)
    _close(lg_t, lg_j)
    rng = np.random.default_rng(8)
    step_j = jax.jit(mj.decode_step)
    for _ in range(8):  # 12 + 8 rows: a 16-row ring wraps
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        lg_j, c_j = step_j(params_j, c_j, jnp.asarray(tok))
        lg_t, out = mt.decode_step(params_t, c_t, torch.as_tensor(tok))
        assert out is c_t
        _close(lg_t, lg_j)
    for name in ("k", "v"):
        _close(c_t["layers"][name], c_j["layers"][name])
    assert int(c_t["len"]) == int(c_j["len"]) == 20


@pytest.mark.parametrize("t", [9, 16, 23, 40])
def test_fit_window_cache_and_finalize_ring_match_jax(pair, t):
    """A windowed prefill keeps its last rows in ring order; folding a
    linear staging cache (``finalize_ring_cache``) gives the same rows."""
    cfg_j, params_j, cfg_t, params_t = _windowed(pair)
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t)
    prompt = _prompts(9, (t,))[0][None]
    _, c_j = mj.prefill(params_j, jnp.asarray(prompt), MAX_LEN)
    _, c_t = mt.prefill(params_t, torch.as_tensor(prompt), MAX_LEN)
    _, staged = mt.prefill(params_t, torch.as_tensor(prompt), MAX_LEN, cache_t=64)
    folded = mt.finalize_ring_cache(staged, WINDOW)
    for name in ("k", "v"):
        assert c_t["layers"][name].shape[2] == WINDOW
        _close(c_t["layers"][name], c_j["layers"][name])
        live = min(t, WINDOW)  # ring slots past the prompt are masked garbage
        idx = [s for s in range(WINDOW) if s < live]
        _close(folded["layers"][name][:, :, idx], c_j["layers"][name][:, :, np.asarray(idx)])


# ---------------------------------------------------------------------------
# engines: tokens against the JAX engines


@pytest.mark.parametrize("chunk", [None, 8], ids=["monolithic", "chunked"])
def test_dense_engine_tokens_match_jax_and_the_paged_layout(pair, chunk):
    prompts, gens = _prompts(10, (11, 19, 5)), [2, 6, 4]
    got, want, eng = _serve_both(pair, prompts, gens, kv_layout="dense",
                                 prefill_chunk_tokens=chunk)
    assert got == want
    assert eng.kv_layout == "dense" and eng.block_pool is None
    assert eng.graph_entries() == 1 and eng.graphs.replays == eng.ticks
    _, _, cfg_t, params_t = pair
    with ops.use(softmax="pallas"):
        paged = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4,
            prefill_chunk_tokens=chunk), device="cpu").serve(prompts, gens)
    assert paged == got


def test_lockstep_granite_matches_the_jax_serve_engine(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    prompts = np.stack(_prompts(11, (9, 9, 9)))
    with jops.use(softmax="pallas"):
        want, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)
                                      ).generate(jnp.asarray(prompts), 12)
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN), device="cpu")
        got, info = eng.generate(prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert info == info_j == {"cache_len": 9 + 11}
    assert (eng.graphs.entries(), eng.graphs.replays) == (1, 11)


RING_PATHS = {
    "dense": dict(kv_layout="dense"),
    "dense_chunked": dict(kv_layout="dense", prefill_chunk_tokens=8),
    "paged": dict(kv_layout="paged", kv_block_size=4),
    "paged_int8": dict(kv_layout="paged", kv_block_size=4, kv_dtype="int8"),
}


@pytest.mark.parametrize("path", list(RING_PATHS))
def test_ring_tokens_match_jax(pair, path):
    """``sliding_window=16`` under ``max_len`` 40: 16-row rings.  Prompts
    shorter and longer than the window, generations past the first lap (the
    int8 ring's later laps reuse the first lap's scale stamps)."""
    prompts, gens = _prompts(12, (6, 23, 30)), [14, 9, 5]
    got, want, eng = _serve_both(_windowed(pair), prompts, gens, **RING_PATHS[path])
    assert got == want and eng._ring
    if eng.kv_layout == "dense":
        assert eng.pool["layers"]["k"].shape[2] == WINDOW
    else:
        assert eng._slot_blocks == WINDOW // 4 and eng.block_pool.used_blocks == 0


def test_lockstep_ring_matches_the_jax_serve_engine(pair):
    cfg_j, params_j, cfg_t, params_t = _windowed(pair)
    for lens, n in (((6, 6), 20), ((23, 23), 9)):
        prompts = np.stack(_prompts(13, lens))
        want, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)
                                      ).generate(jnp.asarray(prompts), n)
        got, info = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN),
                                device="cpu").generate(prompts, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert info == info_j


def test_free_slot_idling_past_cache_t_writes_nothing(pair):
    """Two requests served one after the other on slot 0 while slot 1 sits
    free: slot 1's counters grow past the pool's 16 rows.  Its writes past
    the pool are dropped (no out-of-range index), the live slot's tokens
    equal a 1-slot engine's and the reference's, and the pool equals the
    reference's pool row for row."""
    cfg_j, params_j, cfg_t, params_t = pair
    prompts, gens = _prompts(14, (4, 6)), [12, 11]
    kw = dict(num_slots=2, max_len=16, kv_layout="dense")
    ej = JaxEngine(cfg_j, params_j, JaxConfig(**kw))
    et = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(**kw), device="cpu")
    solo = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
        num_slots=1, max_len=16), device="cpu")
    for p, g in zip(prompts, gens):
        assert et.serve([p], [g]) == ej.serve([p], [g]) == solo.serve([p], [g])
    assert int(et.pool["len"][1]) == et.ticks > 16
    for name in ("k", "v"):
        _close(et.pool["layers"][name], ej.pool["layers"][name])
    np.testing.assert_array_equal(et.pool["len"].numpy(), np.asarray(ej.pool["len"]))


def test_lockstep_over_capacity_raises_where_the_reference_clamps(pair):
    """A prompt of 8 and 6 tokens need 13 rows; ``max_len`` 10 holds 10.
    The reference's ``dynamic_update_slice`` clamps the last writes onto row
    9 and generates without a word (its ``cache_len`` reads 13, and its
    tokens part from those of a cache that fits); the port raises before
    the prefill."""
    cfg_j, params_j, cfg_t, params_t = pair
    prompts = np.stack(_prompts(15, (8,)))
    clamped, info = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=10)
                                   ).generate(jnp.asarray(prompts), 6)
    fits, _ = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=MAX_LEN)
                             ).generate(jnp.asarray(prompts), 6)
    assert info["cache_len"] == 13 > 10 and clamped.shape == (1, 6)
    assert not np.array_equal(np.asarray(clamped), np.asarray(fits))
    eng = ServeEngine(cfg_t, params_t, ServeConfig(max_len=10), device="cpu")
    eng.model.prefill = None  # the refusal comes before any prefill
    with pytest.raises(ValueError, match="needs 13 cache rows"):
        eng.generate(prompts, 6)
    got, _ = ServeEngine(cfg_t, params_t, ServeConfig(max_len=10), device="cpu"
                         ).generate(prompts, 3)  # 10 rows fit
    np.testing.assert_array_equal(got.numpy(), np.asarray(fits)[:, :3])


# ---------------------------------------------------------------------------
# configuration: the layout, refusals, stats


def test_layout_default_refusals_and_the_paged_marker(pair):
    cfg_j, params_j, cfg_t, params_t = pair
    assert ContinuousConfig().kv_layout == "dense"
    with pytest.raises(ValueError, match="kv_dtype='int8' requires kv_layout='paged'"):
        ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(kv_dtype="int8"),
                                 device="cpu")
    with pytest.raises(ValueError, match="prefix_cache requires kv_layout='paged'"):
        ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(prefix_cache=True),
                                 device="cpu")
    with pytest.raises(ValueError, match="kv_layout must be"):
        ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(kv_layout="ring"),
                                 device="cpu")
    small = ContinuousConfig(num_slots=2, max_len=MAX_LEN)
    with ops.use(attention="paged"):
        assert ContinuousBatchingEngine(cfg_t, params_t, small, device="cpu").kv_layout == "paged"
    marked = dataclasses.replace(cfg_t, attn_impl="paged")
    assert ContinuousBatchingEngine(marked, params_t, small, device="cpu").kv_layout == "paged"
    assert ops.resolve(marked.attention_spec)[0].fn is ops.get("attention", "xla").fn
    # the reference's dense kv_stats, key for key and value for value
    want = JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN)).kv_stats()
    got = ContinuousBatchingEngine(cfg_t, params_t, small, device="cpu").kv_stats()
    assert got == want and got["layout"] == "dense"


def test_dense_counters_follow_the_reference(pair):
    """Greedy dense serve: the same ``serve.bytes.h2d`` / ``d2h`` as the
    reference; ``kv.gather.bytes`` counts only on the paged layout."""
    cfg_j, params_j, cfg_t, params_t = pair
    prompts, gens = _prompts(16, (5, 9, 7)), [3, 4, 2]
    ej = JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN))
    et = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN), device="cpu")
    assert et.serve(prompts, gens) == ej.serve(prompts, gens)
    for name in ("serve.bytes.h2d", "serve.bytes.d2h", "kv.gather.bytes"):
        assert et.metrics.counter(name).value() == ej.metrics.counter(name).value(), name
    assert et.metrics.counter("kv.gather.bytes").value() == 0


@pytest.mark.parametrize("argv,expect", [
    (["--engine", "continuous"], "kv=dense"),
    (["--engine", "continuous", "--kv-layout", "paged"], "kv=paged"),
    (["--engine", "continuous", "--attn-impl", "paged"], "kv=paged"),
    ([], "generated (4, 6)"),  # the default engine: lockstep, as the reference's
])
def test_launcher_kv_layout_and_engine_default(argv, expect, capsys):
    rc = launcher.main(["--arch", "granite_8b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--prompt-len", "12", "--gen", "6",
                        "--softmax-impl", "pallas", *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert expect in out


# ---------------------------------------------------------------------------
# the info vector: no host upload inside a captured step


class NoUploadGraph:
    """A stand-in capture object (as ``tests/test_torch_tick.py``'s): the
    step records once with ``torch.tensor`` and ``torch.as_tensor`` of host
    data made to raise, the uploads a CUDA graph cannot capture."""

    def __init__(self, device, stream):
        pass

    def warmup(self, fn):
        fn()

    def capture(self, fn):
        real_tensor, real_as_tensor = torch.tensor, torch.as_tensor

        def no_upload(*args, **kwargs):
            raise RuntimeError("host upload during capture")

        def as_tensor(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise RuntimeError("host upload during capture")
            return real_as_tensor(data, *args, **kwargs)

        torch.tensor, torch.as_tensor = no_upload, as_tensor
        try:
            self.outputs = fn()
        finally:
            torch.tensor, torch.as_tensor = real_tensor, real_as_tensor

    def replay(self):
        return self.outputs


def test_flash_star_info_is_built_without_a_host_upload(pair, monkeypatch):
    """The dense tick (``q_offset = 0``) and the lockstep step (``q_offset =
    len``, a device tensor) capture through ``_attention_pallas`` with host
    uploads raising; a failure would surface as ``GraphCaptureError``."""
    _, _, cfg_t, params_t = pair
    monkeypatch.setattr(engine_mod, "StepGraphs", lambda dev: graph_mod.StepGraphs(
        dev, graph_factory=NoUploadGraph))
    calls = []
    orig = impls._flash_info
    monkeypatch.setattr(impls, "_flash_info", lambda *a: calls.append(a[0]) or orig(*a))
    eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN), device="cpu")
    eng.submit(_prompts(17, (6,))[0], 3)
    eng.run()
    lock = ServeEngine(cfg_t, params_t, ServeConfig(max_len=MAX_LEN), device="cpu")
    lock.generate(np.stack(_prompts(18, (5, 5))), 3)
    assert eng.graph_entries() == 1 and lock.graphs.entries() == 1
    assert any(isinstance(c, torch.Tensor) and c.ndim == 0 for c in calls)  # lockstep len
    assert 0 in [c for c in calls if isinstance(c, int)]  # the dense tick's zero
    with pytest.raises(RuntimeError, match="host upload"):  # the stand-in does bite
        NoUploadGraph(None, None).capture(lambda: torch.as_tensor(0))
