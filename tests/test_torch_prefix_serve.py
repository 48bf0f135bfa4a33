"""The port's prefix cache, chunked prefill and preemption against the JAX
reference.

* ``BlockPool`` / ``PrefixCache`` / ``SlotScheduler``: the same operation
  sequence on the JAX classes and the port's gives the same tables,
  refcounts, free lists, scale pages, hits and evictions (the scenarios of
  ``tests/test_prefix_cache.py`` and ``tests/test_paged_kv.py``, plus
  seeded random traffic).
* ``prefill`` followed by ``prefill_extend`` chunks gives the logits and KV
  of one monolithic port ``prefill``.
* The engine: greedy tokens identical to the JAX engine at smoke size for
  ``kv_dtype`` fp32, int8 and fp8_e4m3, with and without the prefix cache,
  with chunked prefill and on a preempting pool; the two-phase int8
  prefix-cache sequence of ``tests/test_kv_quant.py``; the ``kv_stats()``
  byte fields equal the JAX engine's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as launcher
from repro_torch.models.param import from_reference
from repro_torch.models.registry import build_model
from repro_torch.serve import paged as tpaged
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

try:
    import jax

    from repro import ops as jops
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.param import materialize as jax_materialize
    from repro.models.registry import build_model as jax_build_model
    from repro.serve import paged as jpaged
    from repro.serve import scheduler as jsched
    from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
    from repro.serve.engine import ContinuousConfig as JaxConfig
except ImportError:
    jax = None

MAX_LEN = 40
KV_DTYPES = ("fp32", "int8", "fp8_e4m3")


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


# ---------------------------------------------------------------------------
# host bookkeeping: the same operations on both packages' classes


def _pool_state(pool):
    return {
        "tables": {u: pool.table(u) for u in pool.owners()},
        "refcount": dict(sorted(pool._refcount.items())),
        "free": list(pool._free),
        "used": pool.used_blocks,
        "scale_pages": sorted(pool._scale_pages),
    }


def _trie_state(trie):
    return {"hits": trie.hits, "saved": trie.tokens_saved, "evicted": trie.evicted,
            "nodes": len(trie)}


class _Recorder:
    """Runs calls on one package's objects and records results, raised
    exception types and the allocator state after each call."""

    def __init__(self, mod):
        self.mod = mod
        self.log = []

    def __call__(self, fn, *args):
        try:
            out = fn(*args)
        except (self.mod.PoolExhausted, ValueError) as exc:
            out = type(exc).__name__
        self.log.append(out)
        return out

    def snap(self, pool, trie=None):
        self.log.append(_pool_state(pool))
        if trie is not None:
            self.log.append(_trie_state(trie))


def _sc_lookup_and_insert(m, r):
    pool = m.BlockPool(9, 4)
    trie = m.PrefixCache(pool)
    r(trie.lookup, list(range(12)))
    toks = list(range(8))
    table = r(pool.allocate, 0, 2)
    r(trie.insert, toks, table)
    r(trie.lookup, toks)  # an exact multiple matches one chunk short
    r(trie.lookup, toks + [99])
    r(pool.allocate, 1, 3)
    r(trie.insert, list(range(10)), pool.table(1))  # full blocks only
    r(trie.insert, list(range(10)), pool.table(1))  # first writer wins
    r.snap(pool, trie)


def _sc_branches_and_pins(m, r):
    pool = m.BlockPool(9, 4)
    trie = m.PrefixCache(pool)
    a, b = r(pool.allocate, 0, 2), r(pool.allocate, 1, 2)
    r(trie.insert, [1, 2, 3, 4, 5, 6, 7, 8], a)
    r(trie.insert, [1, 2, 3, 4, 9, 9, 9, 9], b)
    r(trie.lookup, [1, 2, 3, 4, 9, 9, 9, 9, 0])
    r(pool.release, 0)  # pins keep every block allocated
    r(trie.lookup, list(range(8)) + [5])
    r(pool.adopt, 7, a)
    r.snap(pool, trie)


def _sc_eviction(m, r):
    pool = m.BlockPool(9, 4)
    trie = m.PrefixCache(pool)
    a, b = r(pool.allocate, 0, 2), r(pool.allocate, 1, 1)
    r(trie.insert, [1, 2, 3, 4, 5, 6, 7, 8], a)
    r(trie.insert, [9, 9, 9, 9], b)
    r(pool.release, 0)
    r(pool.release, 1)
    r(trie.lookup, [9, 9, 9, 9, 0])
    r(trie.evict_one)  # the LRU leaf, never the interior node
    r(pool.adopt, 5, [a[0]])
    r(pool.adopt, 6, [b[0]])
    r(trie.lookup, [1, 2, 3, 4, 0])
    r(trie.evict_one)  # both shared with live tables: nothing to evict
    r(pool.release, 5)
    r(trie.evict_one)
    r.snap(pool, trie)
    r(trie.clear)
    r.snap(pool, trie)


def _sc_copy_on_write(m, r):
    pool = m.BlockPool(8, 4)
    r(pool.allocate, 0, 3)
    r(pool.fork, 0, 1)
    r(pool.ensure_writable, 1)
    r(pool.ensure_writable, 0)
    r(pool.fork, 1, 2)
    r(pool.ensure_writable, 2, 0)  # an indexed (ring-wrap) write
    r(pool.ensure_writable, 2, 0)
    r.snap(pool)
    r(pool.release, 0)
    r(pool.release, 1)
    r(pool.release, 2)
    r.snap(pool)


def _sc_exhaustion(m, r):
    pool = m.BlockPool(4, 4)
    r(pool.allocate, 0, 2)
    r(pool.allocate, 1, 2)  # PoolExhausted
    r(pool.allocate, 1, 1)
    r(pool.append, 0)
    r(pool.fork, 0, 2)
    r(pool.ensure_writable, 2)  # PoolExhausted: no block for the copy
    r(pool.allocate, 0, 1)  # ValueError: uid owns a table
    r(pool.pin, 0)  # ValueError: unallocated
    r.snap(pool)


def _sc_quantized_scale_pages(m, r):
    pool = m.BlockPool(8, 4, kv_dtype="int8")
    trie = m.PrefixCache(pool)
    t = r(pool.allocate, 0, 3)
    r(trie.insert, list(range(12)), t)
    r(pool.fork, 0, 1)
    r(pool.ensure_writable, 1)
    r(pool.release, 0)
    r(pool.release, 1)
    r.snap(pool, trie)
    r(trie.clear)
    r.snap(pool, trie)


def _random_traffic(seed):
    def scenario(m, r):
        rng = np.random.default_rng(seed)
        pool = m.BlockPool(12, 4, kv_dtype=("fp32", "int8", "fp8_e4m3")[seed % 3])
        trie = m.PrefixCache(pool)
        prompts = [[int(t) for t in rng.integers(0, 3, 4 * int(rng.integers(1, 4)))]
                   for _ in range(6)]
        for _ in range(60):
            uids = pool.owners()
            op = int(rng.integers(0, 8))
            uid = int(rng.integers(0, 6))
            if op == 0:
                r(pool.allocate, uid, int(rng.integers(1, 4)))
            elif op == 1 and uid in uids:
                r(pool.append, uid)
            elif op == 2 and uid in uids:
                r(pool.release, uid)
            elif op == 3 and uids:
                r(pool.fork, int(rng.choice(uids)), uid)
            elif op == 4 and uid in uids:
                r(pool.ensure_writable, uid, int(rng.integers(0, len(pool.table(uid)))))
            elif op == 5 and uid in uids:
                r(trie.insert, prompts[uid], pool.table(uid))
            elif op == 6:
                blocks, _ = r(trie.lookup, prompts[uid])
                if blocks and uid not in uids:
                    r(pool.adopt, uid, blocks)
            elif op == 7:
                r(trie.evict_one)
            r.snap(pool, trie)
    return scenario


SCENARIOS = {
    "lookup_and_insert": _sc_lookup_and_insert,
    "branches_and_pins": _sc_branches_and_pins,
    "eviction": _sc_eviction,
    "copy_on_write": _sc_copy_on_write,
    "exhaustion": _sc_exhaustion,
    "quantized_scale_pages": _sc_quantized_scale_pages,
    **{f"random_{s}": _random_traffic(s) for s in range(6)},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_block_pool_and_prefix_cache_match_reference(name, jax_ref):
    logs = []
    for mod in (jpaged, tpaged):
        rec = _Recorder(mod)
        SCENARIOS[name](mod, rec)
        logs.append(rec.log)
    assert logs[1] == logs[0]
    assert len(logs[1]) > 3


def test_scheduler_preempt_matches_reference(jax_ref):
    logs = []
    for mod in (jsched, tsched):
        sched = mod.SlotScheduler(2)
        u0, u1, u2 = (sched.submit(np.arange(n), 4) for n in (3, 4, 5))
        log = [[s.index for s in sched.admit()]]
        slot0, slot1 = sched.slots
        slot1.prefilling = True
        log.append([[s.index for s in sched.active_slots],
                    [s.index for s in sched.prefilling_slots],
                    [s.index for s in sched.occupied_slots]])
        log.append([sched.record_token(slot0, 7), sched.record_token(slot0, 8)])
        req = sched.preempt(slot0)  # requeued at the front, tokens kept
        log.append((req.uid, list(req.generated_prefix), [r.uid for r in sched.pending]))
        log.append([s.index for s in sched.admit()])
        log.append([sched.record_token(slot0, 9), sched.record_token(slot0, 10)])
        sched.retire(slot0)
        log.append(dict(sched.finished))
        logs.append(log)
    assert logs[1] == logs[0]
    assert logs[1][-1] == {0: [7, 8, 9, 10]}


# ---------------------------------------------------------------------------
# models: chunked prefill equals monolithic prefill


@pytest.fixture(scope="module")
def port_model():
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    from repro_torch.models.param import materialize

    model = build_model(cfg)
    return cfg, model, materialize(model.param_specs(), 0, "cpu")


@pytest.mark.parametrize("chunks", [(8, 3), (4, 4, 2, 1), (1, 10), (2,) * 5 + (1,)])
def test_prefill_extend_chunks_match_monolithic_prefill(chunks, port_model):
    cfg, model, params = port_model
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 11)))
    want_logits, want = model.prefill(params, tokens, 16)
    logits, cache = model.prefill(params, tokens[:, :chunks[0]], 16)
    at = chunks[0]
    for c in chunks[1:]:
        logits, cache = model.prefill_extend(params, cache, tokens[:, at:at + c])
        at += c
    assert int(cache["len"]) == int(cache["pos"]) == 11
    torch.testing.assert_close(logits, want_logits, atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        torch.testing.assert_close(cache["layers"][name], want["layers"][name],
                                   atol=1e-5, rtol=1e-5)


def test_prefill_extend_from_a_gathered_prefix(port_model):
    """A staging cache seeded from pool blocks (the prefix-cache admission)
    continues like the monolithic prefill, at every kv_dtype up to the
    codes' own rounding."""
    cfg, model, params = port_model
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 13)))
    want_logits, _ = model.prefill(params, tokens, 16)
    for kv_dtype, atol in (("fp32", 1e-5), ("int8", 5e-2), ("fp8_e4m3", 2e-1)):
        pool = model.init_paged_cache(6, 4, 1, device="cpu", kv_dtype=kv_dtype)
        _, c8 = model.prefill(params, tokens[:, :8], 8)
        model.write_slot_paged(pool, c8, 0, torch.tensor([4, 2], dtype=torch.int32))
        cache = model.gather_prefix_cache(pool, [4, 2], 8, 16)
        logits, cache = model.prefill_extend(params, cache, tokens[:, 8:])
        torch.testing.assert_close(logits, want_logits, atol=atol, rtol=0)
        assert int(cache["len"]) == 13


# ---------------------------------------------------------------------------
# the engine against the JAX engine


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl="pallas")
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _workload(kind):
    rng = np.random.default_rng(17)
    pre = rng.integers(0, 256, (9,))
    if kind == "preempting":  # 5 requests on a 7-block pool
        suffixes, gens = (3, 7, 2, 11, 5), [6, 4, 7, 5, 3]
    else:
        suffixes, gens = (3, 6, 1, 10), [5, 4, 6, 3]
    prompts = [np.concatenate([pre, rng.integers(0, 256, (n,))]).astype(np.int32)
               for n in suffixes]
    return prompts, gens


MODES = {
    # mode: (ContinuousConfig fields, workload)
    "prefix_chunked": (dict(prefix_cache=True, prefill_chunk_tokens=8), "shared"),
    "chunked": (dict(prefill_chunk_tokens=4), "shared"),
    "preempting": (dict(prefix_cache=True, prefill_chunk_tokens=8, kv_pool_blocks=7),
                   "preempting"),
}
_JAX_RUNS = {}


def _run_pair(pair, kv_dtype, mode):
    cfg_j, params_j, cfg_t, params_t = pair
    fields, workload = MODES[mode]
    prompts, gens = _workload(workload)
    kw = dict(num_slots=2, max_len=MAX_LEN, kv_block_size=4, kv_dtype=kv_dtype, **fields)
    key = (kv_dtype, mode)
    if key not in _JAX_RUNS:
        with jops.use(softmax="pallas"):
            eng_j = JaxEngine(cfg_j, params_j, JaxConfig(kv_layout="paged", **kw))
            _JAX_RUNS[key] = (eng_j.serve(prompts, gens), eng_j)
    with ops.use(softmax="pallas"):
        eng_t = ContinuousBatchingEngine(cfg_t, params_t,
                                         ContinuousConfig(kv_layout="paged", **kw), device="cpu")
        got = eng_t.serve(prompts, gens)
    want, eng_j = _JAX_RUNS[key]
    return got, want, eng_t, eng_j


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_engine_greedy_tokens_identical_to_reference(kv_dtype, mode, pair):
    got, want, eng_t, eng_j = _run_pair(pair, kv_dtype, mode)
    assert got == want
    assert eng_t.ticks == eng_j.ticks
    assert eng_t.preemptions == eng_j.preemptions
    assert eng_t.kv_stats()["prefix"] == eng_j.kv_stats()["prefix"]
    if mode == "preempting":
        assert eng_t.preemptions >= 1 and eng_t.kv_stats()["prefix"]["hits"] >= 1
    assert all(len(g) == n for g, n in zip(got, _workload(MODES[mode][1])[1]))


BYTE_FIELDS = ("kv_bytes_per_token", "kv_bytes_in_use", "kv_bytes_capacity", "peak_kv_bytes",
               "used_blocks", "free_blocks", "total_blocks", "peak_used_blocks", "kv_dtype")


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_kv_stats_byte_fields_equal_the_reference(kv_dtype, pair):
    _, _, eng_t, eng_j = _run_pair(pair, kv_dtype, "preempting")
    st_t, st_j = eng_t.kv_stats(), eng_j.kv_stats()
    assert {k: st_t[k] for k in BYTE_FIELDS} == {k: st_j[k] for k in BYTE_FIELDS}
    assert eng_t.kv_row_bytes() == eng_j.kv_row_bytes()
    assert eng_t.kv_scale_bytes_per_block() == eng_j.kv_scale_bytes_per_block()
    cfg = eng_t.cfg
    per_elem = 4 if kv_dtype == "fp32" else 1  # smoke computes in float32
    assert eng_t.kv_row_bytes() == 2 * per_elem * cfg.num_layers * cfg.num_kv_heads * \
        cfg.resolved_head_dim


def test_engine_int8_prefix_cache_two_phase_parity(pair):
    """The sequence of ``test_engine_int8_prefix_cache_parity``: the first
    prompt's blocks are in the trie before the second prompt prefills, so
    the second adopts the shared int8 blocks (and their scales)."""
    cfg_j, params_j, cfg_t, params_t = pair
    rng = np.random.default_rng(19)
    prefix = rng.integers(0, cfg_t.vocab_size, (9,)).astype(np.int32)
    suffix = rng.integers(0, cfg_t.vocab_size, (4,)).astype(np.int32)
    prompts = [prefix, np.concatenate([prefix, suffix])]
    kw = dict(num_slots=2, max_len=MAX_LEN, kv_block_size=4, kv_dtype="int8",
              prefix_cache=True, prefill_chunk_tokens=8)

    def two_phase(eng):
        u0 = eng.submit(prompts[0], 3)
        first = eng.run()[u0]
        u1 = eng.submit(prompts[1], 3)
        return [first, eng.run()[u1]]

    with jops.use(paged_attention="pallas_paged"):
        eng_j = JaxEngine(cfg_j, params_j, JaxConfig(kv_layout="paged", **kw))
        want = two_phase(eng_j)
    eng_t = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(kv_layout="paged", **kw),
                                     device="cpu")
    got = two_phase(eng_t)
    assert got == want
    assert eng_t.kv_stats()["prefix"]["hits"] == eng_j.kv_stats()["prefix"]["hits"] == 1


# ---------------------------------------------------------------------------
# preemption policy (port only)


def test_preemption_evicts_latest_first_and_keeps_outputs(port_model):
    """The latest-admitted request is the victim (uid 0 never yields), and
    every preempted request completes with its uncontended output."""
    cfg, _, params = port_model
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (7, 9, 5)]
    gens = [8, 7, 6]
    alone = [ContinuousBatchingEngine(cfg, params, ContinuousConfig(
        num_slots=1, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4), device="cpu").serve([p], [g])[0]
        for p, g in zip(prompts, gens)]
    for fields in ({}, dict(prefix_cache=True, prefill_chunk_tokens=4)):
        eng = ContinuousBatchingEngine(cfg, params, ContinuousConfig(
            num_slots=3, max_len=MAX_LEN, kv_layout="paged", kv_block_size=4, kv_pool_blocks=6,
            **fields),
            device="cpu")
        victims = []
        orig = eng._preempt
        eng._preempt = lambda s: (victims.append(s.request.uid), orig(s))[1]
        assert eng.serve(prompts, gens) == alone
        assert victims and 0 not in victims
        assert eng.metrics.counter("serve.requests.preempted").value() == len(victims)


def test_sampled_stream_survives_preemption(port_model):
    """A request's generator lives until it finishes, so a preempted and
    resumed sampled request draws the tokens of an uncontended run."""
    cfg, _, params = port_model
    prompt = np.random.default_rng(21).integers(0, cfg.vocab_size, (5,))

    def engine(**kw):
        return ContinuousBatchingEngine(cfg, params, ContinuousConfig(
            num_slots=2, max_len=MAX_LEN, temperature=1.0, kv_layout="paged", kv_block_size=4,
            **kw),
            device="cpu")

    filler = np.arange(7)  # uid 0: grows into the last free block
    solo = engine()
    solo.submit(filler, 6)
    u = solo.submit(prompt, 6)
    want = solo.run()[u]
    packed = engine(kv_pool_blocks=4)  # 2 + 2 blocks at admission
    packed.submit(filler, 6)
    u = packed.submit(prompt, 6)
    assert packed.run()[u] == want
    assert packed.preemptions >= 1


def test_engine_config_validation(port_model):
    cfg, _, params = port_model
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        ContinuousBatchingEngine(cfg, params, ContinuousConfig(kv_layout="paged",
                                                                prefill_chunk_tokens=0),
                                 device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatchingEngine(cfg, params, ContinuousConfig(kv_layout="paged", kv_dtype="int4"),
                                 device="cpu")


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_launcher_quantized_prefix_chunked_on_cpu(kv_dtype, capsys):
    rc = launcher.main(["--arch", "granite_8b", "--smoke", "--device", "cpu",
                        "--engine", "continuous", "--kv-layout", "paged",
                        "--attn-impl", "pallas", "--softmax-impl", "pallas",
                        "--kv-dtype", kv_dtype, "--prefix-cache",
                        "--prefill-chunk-tokens", "8", "--kv-pool-blocks", "12",
                        "--requests", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "served 4 requests" in out and f"kv_dtype={kv_dtype}" in out
    assert "prefix cache:" in out and "preemptions" in out
