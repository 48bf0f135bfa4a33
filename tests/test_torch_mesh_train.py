"""The port's sharded training and forward on a ``(2, 2)`` ``("data",
"model")`` mesh of 4 gloo ranks against the JAX reference on 4 fake XLA
devices (each in subprocesses with their own time limit).

* ``run_train`` of granite's smoke config for 6 steps from the reference's
  initial state (its step-0 checkpoint): every step's loss equal to the
  reference's sharded run at float32 rounding (``rel 2e-6``, the one-step
  tolerance of ``tests/test_torch_train.py``; the reductions run in another
  order), and within the reference's own ``5e-3`` of the port's run on one
  device;
* the same model with ``seq_parallel_activations``: the q rows sharded over
  "model", so each rank's causal mask starts at its shard's row offset
  (wrong offsets pass on a ``(1, 1)`` mesh and fail here): the logits on
  every attention route and every gradient, under the STAR and the exact
  softmax, against the unsharded port at ``atol 1e-5``;
* granite-moe's expert-parallel forward (``moe_style="ep"``: experts over
  "model") from the reference's parameters, restored onto the mesh by
  ``restore(shardings=...)``: logits against the reference's sharded
  forward at ``atol 1e-4`` (``tests/test_torch_moe.py``'s logit bound).
"""

import shutil

import numpy as np
import pytest

from _torch_mesh import run_jax, run_ranks

pytest.importorskip("jax")

LOSS_RTOL = 2e-6
SINGLE_ATOL = 5e-3
SP_ATOL = 1e-5
MOE_ATOL = 1e-4


def test_sharded_train_matches_reference_and_one_device(tmp_path):
    ref = run_jax(f"""
        import jax
        from repro.checkpoint import checkpointer
        from repro.configs import get_smoke_config
        from repro.launch.mesh import make_mesh
        from repro.models.registry import build_model
        from repro.train.loop import LoopConfig, run_train
        from repro.train.state import init_state
        from repro.train.step import TrainConfig
        TC = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
        CFG = get_smoke_config("granite_8b")
        state = init_state(build_model(CFG).param_specs(), jax.random.PRNGKey(0))
        checkpointer.save("{tmp_path}/ckpt0", 0, state)
        lc = LoopConfig(num_steps=6, batch=8, seq_len=32, log_every=100)
        r = run_train(CFG, TC, lc, mesh=make_mesh((2, 2), ("data", "model")),
                      log_fn=lambda *_: None)
        result([h["loss"] for h in r["history"]])
    """, devices=4)
    for name in ("mesh", "one"):
        shutil.copytree(tmp_path / "ckpt0", tmp_path / f"ckpt_{name}")
    got = run_ranks(f"""
        from repro_torch.configs import get_smoke_config
        from repro_torch.train.loop import LoopConfig, run_train
        from repro_torch.train.step import TrainConfig
        TC = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
        CFG = get_smoke_config("granite_8b")
        lc = LoopConfig(num_steps=6, batch=8, seq_len=32, log_every=100,
                        ckpt_dir="{tmp_path}/ckpt_mesh")
        logs = []
        r = run_train(CFG, TC, lc, mesh=make_mesh((2, 2), ("data", "model"), "cpu"),
                      log_fn=logs.append)
        leaf = r["state"]["params"]["blocks"]["attn"]["wq"]
        result({{"loss": [h["loss"] for h in r["history"]], "resumed": logs[0],
                 "placements": [str(p) for p in leaf.placements],
                 "local": list(leaf.to_local().shape)}})
    """, world=4, tmp_path=tmp_path, name="train")

    from repro_torch.configs import get_smoke_config
    from repro_torch.train.loop import LoopConfig, run_train
    from repro_torch.train.step import TrainConfig

    one = run_train(get_smoke_config("granite_8b"),
                    TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20),
                    LoopConfig(num_steps=6, batch=8, seq_len=32, log_every=100,
                               ckpt_dir=str(tmp_path / "ckpt_one")),
                    device="cpu", log_fn=lambda *_: None)
    one = [h["loss"] for h in one["history"]]
    assert len(ref) == 6
    for r in got:
        assert r["resumed"] == "[loop] resumed from step 0"
        # wq [L, d, heads]: embed over data, heads over model
        assert r["placements"] == ["S(1)", "S(2)"]
        assert r["local"] == [2, 32, 32]
        assert r["loss"] == got[0]["loss"]  # every rank reads the same loss
        np.testing.assert_allclose(r["loss"], ref, rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(r["loss"], one, rtol=0, atol=SINGLE_ATOL)


def test_seq_parallel_rows_sharded_match_one_device(tmp_path):
    got = run_ranks("""
        import dataclasses
        from repro_torch.configs import get_smoke_config
        from repro_torch.data.synthetic import make_batch
        from repro_torch.distributed.sharding import (
            DEFAULT_RULES, distribute, param_shardings, sharding_of, use_mesh_rules)
        from repro_torch.models.param import materialize, named_leaves
        from repro_torch.models.registry import build_model
        from repro_torch.train.step import value_and_grad
        from repro_torch import ops
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        errs = {}
        # the STAR config (its blocked route gives Q / K no gradient) and the
        # exact softmax, whose Q / K gradients cross the row shards
        for kind in ("star", "exact"):
            cfg = dataclasses.replace(get_smoke_config("granite_8b"), softmax_kind=kind,
                                      seq_parallel_activations=True)
            model = build_model(cfg)
            specs = model.param_specs()
            params = materialize(specs, 0, "cpu")
            batch = {k: torch.from_numpy(v) for k, v in
                     make_batch(cfg, batch=4, seq_len=32, step=0).items()}
            want_loss, want_grads = value_and_grad(model, params, batch)
            dparams = distribute(params, param_shardings(specs, DEFAULT_RULES, mesh))
            dbatch = {k: sharding_of(("batch", "seq"), v.shape, DEFAULT_RULES, mesh).place(v)
                      for k, v in batch.items()}
            with use_mesh_rules(mesh, DEFAULT_RULES):
                loss, grads = value_and_grad(model, dparams, dbatch)
            errs[f"{kind}/loss"] = float((loss.full_tensor() - want_loss).abs())
            for (path, g), (_, w) in zip(named_leaves(grads), named_leaves(want_grads)):
                errs[f"{kind}/" + "/".join(path)] = float((g.full_tensor() - w).abs().max())
            nonzero = float(want_grads["blocks"]["attn"]["wq"].abs().max()) > 0
            assert nonzero == (kind == "exact")
            for impl in ("xla", "pallas", "reference"):  # every attention route
                with torch.no_grad(), ops.use(attention=impl):
                    want = model.forward(params, batch["tokens"])
                    with use_mesh_rules(mesh, DEFAULT_RULES):
                        got = model.forward(dparams, dbatch["tokens"]).full_tensor()
                errs[f"{kind}/logits/{impl}"] = float((got - want).abs().max())
        result(errs)
    """, world=4, tmp_path=tmp_path, name="sp")
    for errs in got:
        assert len(errs) == 2 * (1 + 12 + 3)
        for name, err in errs.items():
            assert err <= SP_ATOL, (name, err)


def test_ep_moe_forward_matches_reference(tmp_path):
    ref = run_jax(f"""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from repro.checkpoint import checkpointer
        from repro.configs import get_smoke_config
        from repro.distributed.sharding import DEFAULT_RULES, param_shardings, use_mesh_rules
        from repro.launch.mesh import make_mesh
        from repro.models.param import materialize
        from repro.models.registry import build_model
        cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"), moe_style="ep")
        model = build_model(cfg)
        mesh = make_mesh((2, 2), ("data", "model"))
        params = materialize(model.param_specs(), jax.random.PRNGKey(0))
        checkpointer.save("{tmp_path}/moe", 0, params)
        params = jax.device_put(params, param_shardings(model.param_specs(), DEFAULT_RULES,
                                                        mesh))
        toks = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16)),
                           jnp.int32)
        with use_mesh_rules(mesh, DEFAULT_RULES):
            logits = jax.jit(model.forward)(params, toks)
        np.save("{tmp_path}/moe_logits.npy", np.asarray(logits))
        np.save("{tmp_path}/moe_tokens.npy", np.asarray(toks))
        result(list(logits.shape))
    """, devices=4)
    got = run_ranks(f"""
        import dataclasses
        from repro_torch.checkpoint import checkpointer
        from repro_torch.configs import get_smoke_config
        from repro_torch.distributed.sharding import (
            DEFAULT_RULES, param_shardings, sharding_of, use_mesh_rules)
        from repro_torch.models.registry import build_model
        cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"), moe_style="ep")
        model = build_model(cfg)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        specs = model.param_specs()
        params, _ = checkpointer.restore("{tmp_path}/moe", specs,
                                         shardings=param_shardings(specs, DEFAULT_RULES, mesh))
        wi = params["blocks"]["moe"]["wi"]
        toks = torch.from_numpy(np.load("{tmp_path}/moe_tokens.npy"))
        toks = sharding_of(("batch", "seq"), toks.shape, DEFAULT_RULES, mesh).place(toks)
        with use_mesh_rules(mesh, DEFAULT_RULES):
            logits = model.forward(params, toks)
        want = torch.from_numpy(np.load("{tmp_path}/moe_logits.npy"))
        full = logits.full_tensor()
        result({{"err": float((full - want).abs().max()), "finite": bool(full.isfinite().all()),
                 "expert_placements": [str(p) for p in wi.placements],
                 "local_experts": wi.to_local().shape[1]}})
    """, world=4, tmp_path=tmp_path, name="moe")
    assert ref == [4, 16, 512]
    for r in got:
        assert r["finite"]
        # wi [L, experts, embed, mlp]: experts over model, embed over data
        assert r["expert_placements"] == ["S(2)", "S(1)"]
        assert r["local_experts"] == 4
        assert r["err"] <= MOE_ATOL, r["err"]
