"""Decode over a KV cache sharded along its rows ("kv_seq" over "model"),
and the projection that runs on the shards, on a ``(2, 2)`` ``("data",
"model")`` mesh of 4 gloo ranks against the JAX reference on 4 fake XLA
devices under the same rules (each in subprocesses with their own time
limit; helpers in ``tests/_torch_mesh.py``).

* ``decode_step`` of granite's smoke config, two tokens over a 16-row cache
  whose rows split 8 / 8 (the first token's row in one shard, the second's
  in the other), from the reference's parameters and prefill cache: the
  logits and the whole cache after both steps within ``1e-5`` of the
  reference's sharded ``decode_step``, for the STAR gather and histogram
  modes, the exact softmax, the STE softmax and a ring (a window the
  cache's size); no
  rank's all-gather takes a cache leaf's local shard;
* ``impl="pallas"`` and a faulty softmax over the split rows raise
  ``KVRowsShardedError``;
* on a one-rank ``(1, 1)`` mesh the rows are whole and ``impl="pallas"``
  decodes, equal to the same decode without the mesh (``1e-5``);
* ``matmul_on_shards`` with the batch over "data" and the rows over "model"
  (sequence parallelism): the output and both gradients within ``1e-5`` of
  one device, the weight's gradient reduced into the weight's placement;
  ``matmul_plan`` makes that gradient ``Partial`` on every mesh dim that
  shards the input's rows.
"""

import numpy as np
import pytest

from _torch_mesh import run_jax, run_ranks

pytest.importorskip("jax")

ATOL = 1e-5

VARIANTS = """
import dataclasses

VARIANTS = ("star", "histogram", "exact", "star_ste", "ring")


def variant(name, cfg, ops):
    att = cfg.attention
    if name == "exact":
        att = dataclasses.replace(att, softmax=ops.SoftmaxSpec(kind="exact"))
    if name == "star_ste":
        att = dataclasses.replace(att, softmax=dataclasses.replace(att.softmax, kind="star_ste"))
    if name == "histogram":
        att = dataclasses.replace(att, softmax=dataclasses.replace(att.softmax, mode="histogram"))
    cfg = dataclasses.replace(cfg, attention=att)
    if name == "ring":  # the window is the cache's rows: decode writes at len % 16
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg
"""


def test_kv_seq_decode_matches_reference(tmp_path):
    ref = run_jax(VARIANTS + f"""
import jax, jax.numpy as jnp, numpy as np
from repro import ops
from repro.checkpoint import checkpointer
from repro.configs import get_smoke_config
from repro.distributed.sharding import DEFAULT_RULES, param_shardings, use_mesh_rules
from repro.launch.mesh import make_mesh
from repro.models.param import materialize
from repro.models.registry import build_model
mesh = make_mesh((2, 2), ("data", "model"))
rng = np.random.default_rng(0)
toks = jnp.asarray(rng.integers(0, 256, (4, 7)), jnp.int32)
steps = rng.integers(0, 256, (2, 4, 1)).astype(np.int32)
np.save("{tmp_path}/steps.npy", steps)
for name in VARIANTS:
    cfg = variant(name, get_smoke_config("granite_8b"), ops)
    model = build_model(cfg)
    params = materialize(model.param_specs(), jax.random.PRNGKey(0))
    _, cache = model.prefill(params, toks, 16)
    checkpointer.save("{tmp_path}/" + name + "_params", 0, params)
    checkpointer.save("{tmp_path}/" + name + "_cache", 0, cache)
    with use_mesh_rules(mesh, DEFAULT_RULES):
        step = jax.jit(model.decode_step, in_shardings=(
            param_shardings(model.param_specs(), DEFAULT_RULES, mesh),
            param_shardings(model.cache_spec(4, 16), DEFAULT_RULES, mesh), None))
        logits = []
        for t in steps:
            lg, cache = step(params, cache, jnp.asarray(t))
            logits.append(np.asarray(lg))
    np.save("{tmp_path}/" + name + "_logits.npy", np.stack(logits))
    np.save("{tmp_path}/" + name + "_k.npy", np.asarray(cache["layers"]["k"]))
    np.save("{tmp_path}/" + name + "_v.npy", np.asarray(cache["layers"]["v"]))
result(int(cache["len"]))
""", devices=4)
    got = run_ranks(VARIANTS + f"""
from repro_torch import ops
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, KVRowsShardedError, param_shardings, sharding_of, use_mesh_rules)
from repro_torch.launch.roofline import CostCounter
from repro_torch.models.param import named_leaves
from repro_torch.models.registry import build_model
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
steps = torch.from_numpy(np.load("{tmp_path}/steps.npy"))


def restored(name, cfg):
    model = build_model(cfg)
    specs, cspecs = model.param_specs(), model.cache_spec(4, 16)
    params, _ = checkpointer.restore("{tmp_path}/" + name + "_params", specs,
                                     shardings=param_shardings(specs, DEFAULT_RULES, mesh))
    cache, _ = checkpointer.restore("{tmp_path}/" + name + "_cache", cspecs,
                                    shardings=param_shardings(cspecs, DEFAULT_RULES, mesh))
    return model, params, cache


out = {{}}
for name in VARIANTS:
    model, params, cache = restored(name, variant(name, get_smoke_config("granite_8b"), ops))
    ck = cache["layers"]["k"]
    out["placements"] = [str(p) for p in ck.placements]
    out["local_rows"] = ck.to_local().shape[2]
    local = {{tuple(leaf.to_local().shape[i:]) for _, leaf in named_leaves(cache)
              if leaf.ndim >= 3 for i in (0, 1)}}
    logits = []
    with torch.no_grad(), use_mesh_rules(mesh, DEFAULT_RULES), \\
            CostCounter() as cc:
        for t in steps:
            tok = sharding_of(("batch", None), t.shape, DEFAULT_RULES, mesh).place(t)
            logits.append(model.decode_step(params, cache, tok)[0])
    logits = torch.stack([lg.full_tensor() for lg in logits])
    out[name + "/logits"] = float((logits - torch.from_numpy(
        np.load("{tmp_path}/" + name + "_logits.npy"))).abs().max())
    for leaf in ("k", "v"):
        want = torch.from_numpy(np.load("{tmp_path}/" + name + "_" + leaf + ".npy"))
        full = cache["layers"][leaf].full_tensor()
        out[name + "/" + leaf] = float((full - want).abs().max())
    out[name + "/len"] = int(cache["len"].full_tensor())
    out[name + "/cache_gathers"] = sum(
        1 for op, shapes, _, _ in cc.calls
        if op == "all-gather" and any(tuple(s) in local for s in shapes))
    out[name + "/all_reduces"] = cc.count.get("all-reduce", 0)

base = variant("star", get_smoke_config("granite_8b"), ops)
faulty = dataclasses.replace(base, attention=dataclasses.replace(
    base.attention, softmax=dataclasses.replace(
        base.attention.softmax, fault=ops.FaultModel(stuck_on_rate=0.05))))
pallas = dataclasses.replace(base, attention=dataclasses.replace(base.attention, impl="pallas"))
for label, cfg in (("pallas", pallas), ("fault", faulty)):
    model, params, cache = restored("star", cfg)
    tok = sharding_of(("batch", None), steps[0].shape, DEFAULT_RULES, mesh).place(steps[0])
    try:
        with torch.no_grad(), use_mesh_rules(mesh, DEFAULT_RULES):
            model.decode_step(params, cache, tok)
        out["refused/" + label] = "no error"
    except KVRowsShardedError as exc:
        out["refused/" + label] = type(exc).__name__
result(out)
""", world=4, tmp_path=tmp_path, name="kvseq", timeout=300)
    assert ref == 9
    for r in got:
        # k [L, B, T, Hkv, D]: batch over data, rows over model
        assert r["placements"] == ["S(1)", "S(2)"]
        assert r["local_rows"] == 8
        for name in ("star", "histogram", "exact", "star_ste", "ring"):
            for leaf in ("logits", "k", "v"):
                assert r[f"{name}/{leaf}"] <= ATOL, (name, leaf, r[f"{name}/{leaf}"])
            assert r[f"{name}/len"] == 9
            assert r[f"{name}/cache_gathers"] == 0
            assert r[f"{name}/all_reduces"] > 0  # the split softmax's reductions
        assert r["refused/pallas"] == "KVRowsShardedError"
        assert r["refused/fault"] == "KVRowsShardedError"


class _RankDim:
    """``across`` over ranks stood in for by a leading dim: slice ``r`` of
    a tensor is rank ``r``'s partial, and a reduction gives every rank the
    same result."""

    @staticmethod
    def max(t):
        return t.amax(dim=0, keepdim=True).expand_as(t)

    @staticmethod
    def sum(t):
        return t.sum(dim=0, keepdim=True).expand_as(t)


@pytest.mark.parametrize("kind, mode", [("exact", None), ("star", "gather"),
                                        ("star", "histogram"), ("star_ste", "gather"),
                                        ("star_ste", "histogram")])
def test_softmax_split_across_ranks_equals_the_whole_row(kind, mode):
    """A row of 64 split 4 ways, each rank's slice a row of a leading dim:
    every split softmax (forward, and the STE backward) equals the whole
    row's, within ``1e-6`` (only the sums' order differs); masked entries
    included."""
    import torch

    from repro_torch.core.attention import SoftmaxConfig

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 3, (3, 64)).astype(np.float32))
    where = torch.from_numpy(rng.random((3, 64)) > 0.2)
    g = torch.from_numpy(rng.normal(0, 1, (3, 64)).astype(np.float32))
    sm = SoftmaxConfig(kind=kind) if mode is None else SoftmaxConfig(kind=kind, mode=mode)

    def split(t):  # [3, 64] -> [4 ranks, 3, 16]
        return t.reshape(3, 4, 16).permute(1, 0, 2)

    xw, xs = x.clone().requires_grad_(True), split(x).clone().requires_grad_(True)
    whole = sm.apply(xw, where=where)
    parts = sm.apply(xs, where=split(where), across=_RankDim)
    assert float((split(whole) - parts).detach().abs().max()) <= 1e-6
    if kind == "star_ste":
        (whole * g).sum().backward()
        (parts * split(g)).sum().backward()
        assert float((split(xw.grad) - xs.grad).abs().max()) <= 1e-6


def test_whole_rows_on_one_rank_take_the_kernel_route(tmp_path):
    got = run_ranks("""
import dataclasses
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, distribute, param_shardings, sharding_of, use_mesh_rules)
from repro_torch.models.param import materialize
from repro_torch.models.registry import build_model
mesh = make_mesh((1, 1), ("data", "model"), "cpu")
cfg = get_smoke_config("granite_8b")
cfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, impl="pallas"))
model = build_model(cfg)
specs = model.param_specs()
params = materialize(specs, 0, "cpu")
gen = torch.Generator().manual_seed(0)
toks = torch.randint(0, cfg.vocab_size, (4, 7), generator=gen)
step = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen)
with torch.no_grad():
    _, cache = model.prefill(params, toks, 16)
    dcache = distribute({k: (v.clone() if k != "layers" else {n: t.clone() for n, t in v.items()})
                         for k, v in cache.items()},
                        param_shardings(model.cache_spec(4, 16), DEFAULT_RULES, mesh))
    want = model.decode_step(params, cache, step)[0]
    dparams = distribute(params, param_shardings(specs, DEFAULT_RULES, mesh))
    with use_mesh_rules(mesh, DEFAULT_RULES):
        tok = sharding_of(("batch", None), step.shape, DEFAULT_RULES, mesh).place(step)
        got = model.decode_step(dparams, dcache, tok)[0].full_tensor()
result({"err": float((got - want).abs().max()),
        "k": float((dcache["layers"]["k"].full_tensor() - cache["layers"]["k"]).abs().max()),
        "placements": [str(p) for p in dcache["layers"]["k"].placements]})
""", world=1, tmp_path=tmp_path, name="one")
    r = got[0]
    assert r["placements"] == ["S(1)", "S(2)"]  # rows "sharded" over a size-1 dim: whole
    assert r["err"] <= ATOL and r["k"] <= ATOL, r


def test_matmul_on_shards_matches_one_device(tmp_path):
    got = run_ranks("""
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.distributed.sharding import matmul_on_shards
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
gen = torch.Generator().manual_seed(0)
x = torch.randn(4, 8, 16, generator=gen)
w = torch.randn(16, 12, generator=gen)
g = torch.randn(4, 8, 12, generator=gen)
xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
((xr @ wr) * g).sum().backward()
out = {}
# the batch over data and the rows over model (sequence parallelism); w as
# an attention projection: embed over data, heads over model
for label, xp, wp in (("rows", (Shard(0), Shard(1)), (Shard(0), Shard(1))),
                      ("column", (Shard(0), Replicate()), (Shard(0), Shard(1))),
                      ("row", (Shard(0), Shard(2)), (Replicate(), Shard(0)))):
    dx = distribute_tensor(x, mesh, xp).detach().requires_grad_(True)
    dw = distribute_tensor(w, mesh, wp).detach().requires_grad_(True)
    y = matmul_on_shards(dx, dw)
    (y * distribute_tensor(g, mesh, y.placements)).sum().backward()
    out[label] = {"y": float((y.full_tensor() - x @ w).abs().max()),
                  "dx": float((dx.grad.full_tensor() - xr.grad).abs().max()),
                  "dw": float((dw.grad.full_tensor() - wr.grad).abs().max()),
                  "out": [str(p) for p in y.placements],
                  "dw_placements": [str(p) for p in dw.grad.placements]}
result(out)
""", world=4, tmp_path=tmp_path, name="proj")
    for r in got:
        for label, errs in r.items():
            for key in ("y", "dx", "dw"):
                assert errs[key] <= ATOL, (label, key, errs[key])
        assert r["rows"]["out"] == ["S(0)", "S(1)"]
        assert r["rows"]["dw_placements"] == ["S(0)", "S(1)"]  # reduced into w's placement
        assert r["column"]["out"] == ["S(0)", "S(2)"]
        assert r["row"]["out"] == ["S(0)", "R"]  # the partial sums all-reduced at once


def test_matmul_plan_places_the_weight_gradient():
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import matmul_plan

    s0, s1, s2, rep = Shard(0), Shard(1), Shard(2), Replicate()
    x_want, w_want, x_grad, w_grad, out = matmul_plan((s0, s1), (s0, s1), 3)
    # x's rows over model: w whole there, its gradient a partial sum on both dims
    assert (x_want, w_want, out) == ((s0, s1), (rep, rep), (s0, s1))
    assert w_grad == (Partial(), Partial()) and x_grad == (s0, s1)
    # column parallel on model: x whole, the output split along N
    x_want, w_want, x_grad, w_grad, out = matmul_plan((s0, rep), (s0, s1), 3)
    assert (x_want, w_want, x_grad, w_grad, out) == (
        (s0, rep), (rep, s1), (s0, Partial()), (Partial(), s1), (s0, s2))
    # row parallel on model: x cut along K as w, the output a partial sum
    x_want, w_want, x_grad, w_grad, out = matmul_plan((s0, rep), (rep, s0), 3)
    assert (x_want, w_want, out) == ((s0, s2), (rep, s0), (s0, Partial()))
    assert np.all([isinstance(p, (Shard, Replicate, Partial)) for p in x_grad + w_grad])
