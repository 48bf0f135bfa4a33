"""Requests that stop at their EOS token, and their arrival times, against
the JAX reference.

The granite-8b smoke config with ``attn_impl="pallas"`` in both packages
(the reference's kernels in Pallas interpret mode, the port's kernel
wrappers on their plain versions), weights carried by
``models.param.from_reference``, greedy, ``ops.use(softmax="pallas")``.

* the scheduler: EOS beats the budget (``tests/test_scheduler.py``'s
  ``test_completion_by_eos``) on both packages' ``SlotScheduler``;
* EOS at the first token gives ``[eos]`` (``tests/test_serve.py``'s
  ``test_continuous_eos_stops_early``), after a monolithic and a chunked
  admission, on the dense and the paged pool;
* EOS mid-stream on both pools: the JAX engine's tokens, each output the
  no-EOS output cut after the first ``eos_id``, streamed ``TokenEvent`` s
  ending in ``finished=True`` on the EOS token, the same ``graph_entries()``
  as without EOS;
* the prefix-cache + chunked-prefill + int8 + preempting workload with an
  ``eos_id`` that stops a request early: the JAX engine's tokens, ticks and
  preemptions;
* ``arrival_time`` kept on the request and never read by admission.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro import ops as jops
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.param import materialize as jax_materialize
from repro.models.registry import build_model as jax_build_model
from repro.serve import scheduler as jsched
from repro.serve.engine import ContinuousBatchingEngine as JaxEngine
from repro.serve.engine import ContinuousConfig as JaxConfig
from repro_torch import ops
from repro_torch.configs import get_smoke_config
from repro_torch.models.param import from_reference
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

MAX_LEN = 40
LAYOUTS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged", kv_block_size=4),
}


@pytest.fixture(scope="module")
def pair():
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl="pallas")
    params_j = jax_materialize(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    cfg_t = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_t = from_reference(jax.tree_util.tree_map(np.asarray, params_j), cfg_t,
                              device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _jax_engine(pair, **kw):
    cfg_j, params_j, _, _ = pair
    return JaxEngine(cfg_j, params_j, JaxConfig(num_slots=2, max_len=MAX_LEN, **kw))


def _port_engine(pair, **kw):
    _, _, cfg_t, params_t = pair
    events = []
    eng = ContinuousBatchingEngine(cfg_t, params_t, ContinuousConfig(
        num_slots=2, max_len=MAX_LEN, **kw), device="cpu", on_token=events.append)
    return eng, events


def _cut(tokens, eos):
    """``tokens`` up to and including the first ``eos``."""
    return tokens[:tokens.index(eos) + 1] if eos in tokens else tokens


# ---------------------------------------------------------------------------
# the scheduler


@pytest.mark.parametrize("mod", [jsched, tsched], ids=["jax", "port"])
def test_completion_by_eos(mod):
    sched = mod.SlotScheduler(1)
    uid = sched.submit(np.arange(5), 100, eos_id=9)
    (slot,) = sched.admit()
    assert sched.record_token(slot, 3) is False
    assert sched.record_token(slot, 9) is True  # EOS beats the budget
    sched.retire(slot)
    assert sched.finished[uid] == [3, 9]
    assert sched.done()


def test_scheduler_eos_and_arrival_follow_the_reference():
    """The same calls on both schedulers: the requests' fields, what each
    ``record_token`` returns and the finished outputs; a requeued request
    keeps its ``eos_id`` and ``arrival_time``."""
    logs = []
    for mod in (jsched, tsched):
        sched, log = mod.SlotScheduler(2), []
        for n, eos, t in ((3, 5, 2.5), (4, None, 0.5), (2, 7, 9.0)):
            sched.submit(np.arange(1, 4), n, eos_id=eos, arrival_time=t)
        log.append([(r.uid, r.eos_id, r.arrival_time) for r in sched.pending])
        s0, s1 = sched.admit()
        log.append([sched.record_token(s0, 1), sched.record_token(s1, 5)])
        req = sched.preempt(s0)
        log.append((req.eos_id, req.arrival_time, req.generated_prefix))
        (s0,) = sched.admit()
        log.append([sched.record_token(s0, 5), sched.record_token(s1, 2)])
        sched.retire(s0)
        log.append(dict(sched.finished))
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][1] == [False, False] and logs[1][3] == [True, False]


def test_arrival_time_is_kept_and_ignored_by_admission(pair):
    """Arrival times in reverse order change neither the admission order
    nor the tokens; each request keeps its own."""
    prompts, gens = _prompts(3, (7, 5, 9)), [3, 4, 2]
    times = [30.0, 20.0, 10.0]
    with ops.use(softmax="pallas"):
        plain, _ = _port_engine(pair, **LAYOUTS["paged"])
        want = plain.serve(prompts, gens)
        eng, events = _port_engine(pair, **LAYOUTS["paged"])
        uids = [eng.submit(p, g, arrival_time=t) for p, g, t in zip(prompts, gens, times)]
        assert [r.arrival_time for r in eng.scheduler.pending] == times
        eng.step()
        admitted = [s.request.uid for s in eng.scheduler.slots if s.request is not None]
        done = eng.run()
    assert admitted == uids[:2]  # FIFO by submission, not by arrival time
    assert [done[u] for u in uids] == want
    assert [e.uid for e in events if e.index == 0] == uids


# ---------------------------------------------------------------------------
# the engine against the JAX engine


@pytest.mark.parametrize("chunk", [None, 4], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_continuous_eos_stops_early(pair, layout, chunk):
    """EOS at the first token: the request emits ``[eos]`` and frees its
    slot at admission; the other request is untouched."""
    prompts = _prompts(4, (6, 9))
    kw = dict(LAYOUTS[layout], prefill_chunk_tokens=chunk)
    with ops.use(softmax="pallas"):
        free, _ = _port_engine(pair, **kw)
        first = free.serve(prompts[:1], 1)[0][0]
        eng, events = _port_engine(pair, **kw)
        uid = eng.submit(prompts[0], 30, eos_id=first)
        other = eng.submit(prompts[1], 5)
        done = eng.run()
    with jops.use(softmax="pallas"):
        jeng = _jax_engine(pair, **kw)
        juid = jeng.submit(prompts[0], 30, eos_id=first)
        jother = jeng.submit(prompts[1], 5)
        jdone = jeng.run()
    assert done[uid] == [first] == jdone[juid]
    assert done[other] == jdone[jother] and len(done[other]) == 5
    assert [(e.index, e.finished) for e in events if e.uid == uid] == [(0, True)]
    assert eng.ticks == jeng.ticks
    if eng.block_pool is not None:
        assert eng.block_pool.used_blocks == 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eos_mid_stream_matches_reference_and_truncates(pair, layout):
    prompts, gens = _prompts(9, (11, 5, 8, 3)), [8, 6, 9, 7]
    kw = LAYOUTS[layout]
    with ops.use(softmax="pallas"):
        free, _ = _port_engine(pair, **kw)
        full = free.serve(prompts, gens)
        # request 0's first token at index 2 or later that it has not sampled
        # before stops it there (and any other request that samples it)
        at = next(i for i in range(2, len(full[0])) if full[0][i] not in full[0][:i])
        eos = full[0][at]
        eng, events = _port_engine(pair, **kw)
        got = eng.serve(prompts, gens, eos_id=eos)
    with jops.use(softmax="pallas"):
        want = _jax_engine(pair, **kw).serve(prompts, gens, eos_id=eos)
    assert got == want
    assert got == [_cut(f, eos) for f in full]
    assert len(got[0]) == at + 1 < gens[0] and got[0][-1] == eos
    assert eng.graph_entries() == free.graph_entries()
    assert eng.ticks < free.ticks
    for uid, out in enumerate(got):
        mine = [e for e in events if e.uid == uid]
        assert [e.token for e in mine] == out
        assert [e.index for e in mine] == list(range(len(out)))
        assert [e.finished for e in mine] == [False] * (len(out) - 1) + [True]


def _preempting_workload():
    rng = np.random.default_rng(17)
    pre = rng.integers(0, 256, (9,))
    prompts = [np.concatenate([pre, rng.integers(0, 256, (n,))]).astype(np.int32)
               for n in (3, 7, 2, 11, 5)]
    return prompts, [6, 4, 7, 5, 3]


def _early_stopper(outputs):
    """A token that appears in exactly one output, past its first place and
    before its last, so it stops that request early."""
    for i, out in enumerate(outputs):
        for tok in out[1:-1]:
            if not any(tok in o for j, o in enumerate(outputs) if j != i):
                return tok
    raise AssertionError("no token stops exactly one request early")


def test_eos_on_the_prefix_chunked_int8_preempting_workload(pair):
    prompts, gens = _preempting_workload()
    kw = dict(kv_layout="paged", kv_block_size=4, kv_dtype="int8", prefix_cache=True,
              prefill_chunk_tokens=8, kv_pool_blocks=7)
    with ops.use(softmax="pallas"):
        free, _ = _port_engine(pair, **kw)
        full = free.serve(prompts, gens)
        eos = _early_stopper(full)
        eng, events = _port_engine(pair, **kw)
        got = eng.serve(prompts, gens, eos_id=eos)
    with jops.use(softmax="pallas"):
        jeng = _jax_engine(pair, **kw)
        want = jeng.serve(prompts, gens, eos_id=eos)
    assert free.preemptions >= 1
    assert got == want
    assert eng.ticks == jeng.ticks and eng.preemptions == jeng.preemptions
    assert eng.kv_stats()["prefix"] == jeng.kv_stats()["prefix"]
    stopped = [i for i, (g, n) in enumerate(zip(got, gens)) if len(g) < n]
    assert len(stopped) == 1 and got[stopped[0]][-1] == eos
    assert eng.block_pool.used_blocks == jeng.block_pool.used_blocks
    for uid, out in enumerate(got):
        assert [e.token for e in events if e.uid == uid] == out
