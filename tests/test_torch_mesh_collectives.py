"""The port's explicit collectives, pipeline and elastic re-meshing on gloo
ranks against the JAX reference on fake XLA devices (each in subprocesses
with their own time limit).

* ``compressed_grad_allreduce`` over the "data" dim of a ``(2, 2)`` mesh:
  with every rank's gradient equal (the reference's
  ``compressed_grad_allreduce``) and with a gradient a rank (the
  reference's ``_ef_compress_allreduce`` under ``shard_map``).  The codes
  are integers summed exactly in any order, so the mean and the new error
  are bit-equal to the reference's; ``mean + new_err == g`` to ``1e-6``
  where the ranks agree, as the reference's own test;
* ``pipeline_apply`` over 4 stages and 6 microbatches: against the
  sequential loop and the reference's pipeline at ``1e-5`` (the reference's
  bound; XLA's float32 matmul rounds otherwise than torch's);
* elastic: a state saved sharded on ``(2, 2)`` and restored on the mesh
  ``plan_mesh(2, model_parallel=2)`` plans, bit-equal; ``plan_dims``
  against the reference's ``plan_mesh`` shapes;
* a mesh whose device count is not the world size raises
  ``MeshShapeError`` on every rank.
"""

import numpy as np
import pytest

from _torch_mesh import run_jax, run_ranks

pytest.importorskip("jax")

PIPE_ATOL = 1e-5
REC_ATOL = 1e-6


def _grads(rank: int, shape=(8, 16)) -> np.ndarray:
    return np.random.default_rng(100 + rank).normal(size=shape).astype(np.float32)


def test_compressed_allreduce_matches_reference(tmp_path):
    g_all = np.stack([_grads(r) for r in range(4)])  # [rank, ...]
    g_err = (0.01 * np.stack([_grads(10 + r) for r in range(4)])).astype(np.float32)
    np.save(tmp_path / "g.npy", g_all)
    np.save(tmp_path / "e.npy", g_err)
    ref = run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.distributed.collectives import (
            _ef_compress_allreduce, compressed_grad_allreduce, init_error_state)
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((2, 2), ("data", "model"))
        g_all = np.load("{tmp_path}/g.npy")
        e_all = np.load("{tmp_path}/e.npy")
        # every rank the same gradient (rank 0's): the reference's entry point
        g = {{"w": jnp.asarray(g_all[0])}}
        mean, err = compressed_grad_allreduce(g, init_error_state(g), mesh, axis="data")
        np.save("{tmp_path}/same_mean.npy", np.asarray(mean["w"]))
        np.save("{tmp_path}/same_err.npy", np.asarray(err["w"]))
        # a gradient and a carried error a rank: rank r = (data, model) index
        def body(x, e):
            m, ne = _ef_compress_allreduce(x[0, 0], e[0, 0], "data")
            return m[None, None], ne[None, None]
        spec = P("data", "model")
        fn = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))
        m, ne = fn(jnp.asarray(g_all.reshape(2, 2, 8, 16)), jnp.asarray(e_all.reshape(2, 2, 8, 16)))
        np.save("{tmp_path}/diff_mean.npy", np.asarray(m).reshape(4, 8, 16))
        np.save("{tmp_path}/diff_err.npy", np.asarray(ne).reshape(4, 8, 16))
        result("ok")
    """, devices=4)
    assert ref == "ok"
    got = run_ranks(f"""
        from repro_torch.distributed.collectives import compressed_grad_allreduce, init_error_state
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        g_all = torch.from_numpy(np.load("{tmp_path}/g.npy"))
        e_all = torch.from_numpy(np.load("{tmp_path}/e.npy"))
        g = {{"w": g_all[0].clone()}}
        mean, err = compressed_grad_allreduce(g, init_error_state(g), mesh, axis="data")
        same = (mean["w"], err["w"])
        mean, err = compressed_grad_allreduce({{"w": g_all[RANK].clone()}},
                                              {{"w": e_all[RANK].clone()}}, mesh, axis="data")
        w = lambda name: torch.from_numpy(np.load(f"{tmp_path}/{{name}}.npy"))
        result({{
            "same_mean": bool(torch.equal(same[0], w("same_mean"))),
            "same_err": bool(torch.equal(same[1], w("same_err"))),
            "rec": float((same[0] + same[1] - g["w"]).abs().max()),
            "rel": float((same[0] - g["w"]).norm() / g["w"].norm()),
            "diff_mean": bool(torch.equal(mean["w"], w("diff_mean")[RANK])),
            "diff_err": bool(torch.equal(err["w"], w("diff_err")[RANK])),
        }})
    """, world=4, tmp_path=tmp_path, name="ar")
    for r in got:
        assert r["same_mean"] and r["same_err"], r
        assert r["diff_mean"] and r["diff_err"], r
        assert r["rec"] < REC_ATOL, r
        assert r["rel"] < 0.01, r  # the reference test's bound on the int8 mean


def test_pipeline_matches_sequential_and_reference(tmp_path):
    rng = np.random.default_rng(0)
    s, m, mb, d = 4, 6, 2, 16
    np.save(tmp_path / "w.npy", (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32))
    np.save(tmp_path / "x.npy", rng.normal(size=(m, mb, d)).astype(np.float32))
    ref = run_jax(f"""
        import jax.numpy as jnp, numpy as np
        from repro.distributed.pipeline_parallel import pipeline_apply
        from repro.launch.mesh import make_mesh
        mesh = make_mesh((4,), ("stage",))
        out = pipeline_apply(lambda h, W: jnp.tanh(h @ W), jnp.asarray(np.load("{tmp_path}/w.npy")),
                             jnp.asarray(np.load("{tmp_path}/x.npy")), mesh, axis="stage")
        np.save("{tmp_path}/ref.npy", np.asarray(out))
        result("ok")
    """, devices=4)
    assert ref == "ok"
    got = run_ranks(f"""
        from repro_torch.distributed.pipeline_parallel import pipeline_apply
        mesh = make_mesh((4,), ("stage",), "cpu")
        ws = torch.from_numpy(np.load("{tmp_path}/w.npy"))
        x = torch.from_numpy(np.load("{tmp_path}/x.npy"))
        out = pipeline_apply(lambda h, w: torch.tanh(h @ w), ws, x, mesh, axis="stage")
        seq = x
        for i in range(ws.shape[0]):
            seq = torch.tanh(seq @ ws[i])
        ref = torch.from_numpy(np.load("{tmp_path}/ref.npy"))
        result({{"seq": float((out - seq).abs().max()), "ref": float((out - ref).abs().max())}})
    """, world=4, tmp_path=tmp_path, name="pipe")
    for r in got:
        assert r["seq"] < PIPE_ATOL and r["ref"] < PIPE_ATOL, r


def test_elastic_restore_on_a_smaller_mesh(tmp_path):
    cases = ((4, 2), (4, 4), (4, 8), (3, 2), (2, 2), (1, 2))
    ref = run_jax(f"""
        from repro.distributed.elastic import plan_mesh
        result([[int(v) for v in plan_mesh(n, model_parallel=mp).shape.values()]
                for n, mp in {cases}])
    """, devices=4)
    from repro_torch.distributed.elastic import plan_dims

    assert [list(plan_dims(n, mp)) for n, mp in cases] == ref

    save = f"""
        from repro_torch.checkpoint import checkpointer
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed.elastic import plan_mesh, reshard_plan
        from repro_torch.distributed.sharding import DEFAULT_RULES
        from repro_torch.models.param import named_leaves
        from repro_torch.models.registry import build_model
        from repro_torch.train.state import init_state, state_specs
        specs = state_specs(build_model(get_smoke_config("granite_8b")).param_specs())
        state = init_state(build_model(get_smoke_config("granite_8b")).param_specs(), 0,
                           device="cpu")
    """
    got = run_ranks(save + f"""
        mesh = plan_mesh(4, model_parallel=2, device="cpu")
        from repro_torch.distributed.sharding import distribute
        dstate = distribute(state, reshard_plan(specs, DEFAULT_RULES, mesh))
        checkpointer.save("{tmp_path}/ckpt", 1, dstate)
        wq = dstate["params"]["blocks"]["attn"]["wq"]
        result({{"mesh": list(mesh.shape), "local": list(wq.to_local().shape)}})
    """, world=4, tmp_path=tmp_path, name="save")
    assert all(r == {"mesh": [2, 2], "local": [2, 32, 32]} for r in got), got
    got = run_ranks(save + f"""
        mesh = plan_mesh(2, model_parallel=2, device="cpu")
        restored, step = checkpointer.restore("{tmp_path}/ckpt", specs,
                                              shardings=reshard_plan(specs, DEFAULT_RULES, mesh))
        equal = all(torch.equal(r.full_tensor(), s) for (_, r), (_, s) in
                    zip(named_leaves(restored), named_leaves(state)))
        wq = restored["params"]["blocks"]["attn"]["wq"]
        result({{"mesh": list(mesh.shape), "step": step, "equal": equal,
                 "local": list(wq.to_local().shape)}})
    """, world=2, tmp_path=tmp_path, name="restore")
    assert all(r == {"mesh": [1, 2], "step": 1, "equal": True, "local": [2, 64, 32]}
               for r in got), got


def test_mesh_of_the_wrong_size_raises(tmp_path):
    got = run_ranks("""
        from repro_torch.launch.mesh import MeshShapeError
        try:
            make_mesh((2, 1), ("data", "model"), "cpu")
            result("built")
        except MeshShapeError as e:
            result(str(e))
    """, world=4, tmp_path=tmp_path, name="bad")
    assert all(r == "mesh (2, 1) ('data', 'model') needs 2 ranks, the process group has 4"
               for r in got), got
