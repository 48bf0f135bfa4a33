"""The port's training against the JAX reference: one train step of every
arch from the same state, the optimizer and schedules, the synthetic data,
checkpoints crossing between the packages, the loop (convergence, crash and
resume, preemption, the straggler watchdog), the launcher, and
bert-base-star.

The reference's state (parameters, AdamW moments, step) is carried across
leaf by leaf through numpy.  Tolerances, all at float32 rounding (the same
arithmetic in another order):

* loss and gradient norm: ``rel 2e-6``; the learning rate bit-equal;
* every gradient leaf and every updated moment: ``|port - ref| <= 2e-5 *
  max |ref|`` over the leaf (a leaf the reference gives as exact zeros must
  be exact zeros here);
* every updated parameter: ``|port - ref| <= 0.05 * lr`` (Adam's first step
  is ``lr * g / (|g| + eps)``: a gradient entry near ``eps`` in size moves
  by a fraction of ``lr`` under a rounding of ``g``);
* data, checkpoints, schedules' boundaries and the straggler watchdog:
  bit-equal.

The ``cuda`` tests at the end hold the kernels at the shapes the trained
bert-base-star reaches (flash_star float32 at head_dim 64, one head a KV
head; the STAR softmax in histogram mode over its padded vocabulary)
against their plain versions on the card.
"""

import dataclasses
import filecmp
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.fixedpoint import FORMAT_CNEWS
from repro_torch.data.synthetic import DataConfig, batch_iterator, make_batch
from repro_torch.distributed.fault import FailureInjector, StragglerWatchdog
from repro_torch.models.param import count_params, named_leaves
from repro_torch.models.registry import build_model
from repro_torch.optim import schedule as tsched
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.launch.mesh import MeshShapeError, make_mesh
from repro_torch.train.loop import LoopConfig, run_train
from repro_torch.train.state import init_state, state_specs
from repro_torch.train.step import TrainConfig, make_eval_step, make_train_step, value_and_grad

try:  # the machine with the card runs the ``cuda`` tests without JAX
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import checkpointer as jckpt
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.data.synthetic import DataConfig as JDataConfig
    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.distributed.fault import StragglerWatchdog as JWatchdog
    from repro.models.param import count_params as jax_count_params
    from repro.models.registry import build_model as jax_build_model
    from repro.optim import schedule as jsched
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.optim.adamw import adamw_update as jax_adamw_update
    from repro.serve.engine import ServeConfig as JaxServeConfig
    from repro.serve.engine import ServeEngine as JaxServeEngine
    from repro.train.state import init_state as jax_init_state
    from repro.train.step import TrainConfig as JTrainConfig
    from repro.train.step import make_eval_step as jax_make_eval_step
    from repro.train.step import make_train_step as jax_make_train_step
except ImportError:
    jax = None

TC = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
GRAD_RTOL = 2e-5  # of the leaf's largest magnitude
STEP_FRAC = 0.05  # of lr, for updated parameters
LOSS_RTOL = 2e-6
QUIET = dict(log_fn=lambda *_: None)


@pytest.fixture
def jax_ref():
    if jax is None:
        pytest.skip("needs JAX (the reference)")


def to_torch(tree):
    """A reference pytree (nested dicts of JAX / numpy arrays) as tensors
    on the CPU; bfloat16 through its 2-byte payload."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _jax_batch(cfg_j, batch, seq, step=0):
    return {k: jnp.asarray(v) for k, v in
            jax_make_batch(cfg_j, batch=batch, seq_len=seq, step=step).items()}


def _torch_batch(cfg, batch, seq, step=0):
    return {k: torch.from_numpy(v) for k, v in
            make_batch(cfg, batch=batch, seq_len=seq, step=step).items()}


def _reference_step(cfg_j, batch_j, tc, adamw=None):
    """The reference's initial state, its gradients of the loss and its
    train step's ``(state, metrics)``, in one jitted call."""
    model = jax_build_model(cfg_j)
    kw = {} if adamw is None else {"adamw": adamw}
    state = jax_init_state(model.param_specs(), jax.random.PRNGKey(0), **kw)
    step = jax_make_train_step(model, JTrainConfig(**tc, **kw))

    @jax.jit
    def both(st, b):
        return jax.value_and_grad(model.loss)(st["params"], b), step(st, b)

    (_, grads), (new_state, metrics) = both(state, batch_j)
    return state, grads, new_state, metrics


def _assert_tree_close(got, want, what, atol_of=lambda ref: GRAD_RTOL * ref.abs().max()):
    gl, wl = named_leaves(got), named_leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl], what
    for (path, g), (_, w) in zip(gl, wl):
        name = f"{what} {'/'.join(path)}"
        assert g.dtype == w.dtype and g.shape == w.shape, name
        g, w = g.float(), w.float()
        if not w.any():
            assert not g.any(), f"{name}: the reference's exact zeros"
            continue
        diff = float((g - w).abs().max())
        assert diff <= float(atol_of(w)), (name, diff)


def _assert_step_matches(cfg, batch, ref, tc):
    """The port's gradients and train step from the reference's state
    against the reference's."""
    state_j, grads_j, new_j, metrics_j = ref
    state = to_torch(state_j)
    model = build_model(cfg)
    loss, grads = value_and_grad(model, state["params"], batch)
    new_state, metrics = make_train_step(model, TrainConfig(**tc))(state, batch)
    assert float(loss) == float(metrics["loss"])
    for key, rtol in (("loss", LOSS_RTOL), ("grad_norm", LOSS_RTOL), ("lr", 0.0)):
        assert float(metrics[key]) == pytest.approx(float(metrics_j[key]), rel=rtol, abs=0), key
    _assert_tree_close(grads, to_torch(grads_j), "grad")
    want = to_torch(new_j)
    lr = float(metrics_j["lr"])
    _assert_tree_close(new_state["params"], want["params"], "param",
                       atol_of=lambda ref: STEP_FRAC * lr)
    _assert_tree_close(new_state["opt"], want["opt"], "moment",
                       atol_of=lambda ref: GRAD_RTOL * ref.abs().max() + 1e-12)
    assert int(new_state["step"]) == int(want["step"]) == 1
    return grads


# ---------------------------------------------------------------------------
# one train step of every arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_train_step_matches_reference(arch, jax_ref):
    """Every arch at its smoke config, batch 2 x 16 tokens, from the
    reference's initial state: loss, gradient norm, lr, every gradient
    leaf, every updated parameter and moment (the reference runs the same
    step in ``tests/test_models_smoke.py``)."""
    cfg_j, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    ref = _reference_step(cfg_j, _jax_batch(cfg_j, 2, 16), TC)
    _assert_step_matches(cfg, _torch_batch(cfg, 2, 16), ref, TC)


@pytest.mark.parametrize("attn_impl", ("blocked", "reference"))
def test_star_ste_train_step_matches_reference(attn_impl, jax_ref):
    """``star_ste`` on granite's smoke config at 48 tokens, over block_kv
    32: ``blocked`` runs the online loop, whose integer-grid form leaves
    ``wq`` / ``wk`` an exact zero gradient in both packages; ``reference``
    (whole-operand) trains them through the STE."""
    cfg_j = dataclasses.replace(jax_smoke_config("granite_8b"), attn_impl=attn_impl,
                                softmax_kind="star_ste")
    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl=attn_impl,
                              softmax_kind="star_ste")
    assert cfg.attention_spec.softmax.kind == "star_ste"
    ref = _reference_step(cfg_j, _jax_batch(cfg_j, 2, 48), TC)
    grads = _assert_step_matches(cfg, _torch_batch(cfg, 2, 48), ref, TC)
    zero = [not grads["blocks"]["attn"][w].any() for w in ("wq", "wk")]
    assert zero == [attn_impl == "blocked"] * 2
    assert grads["blocks"]["attn"]["wv"].any()


def test_eval_step_matches_reference_on_both_routes(jax_ref):
    """``make_eval_step`` (no grad) on bert-base-star's smoke config: the
    reference's loss at float32 rounding, and the same loss through the
    ``pallas`` attention (the flash_star kernel's plain version here)."""
    cfg_j, cfg = jax_smoke_config("bert_base_star"), get_smoke_config("bert_base_star")
    state_j = jax_init_state(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    want = float(jax_make_eval_step(jax_build_model(cfg_j))(state_j, _jax_batch(cfg_j, 2, 24)))
    state, batch = to_torch(state_j), _torch_batch(cfg, 2, 24)
    eval_step = make_eval_step(build_model(cfg))
    got = eval_step(state, batch)
    assert not got.requires_grad
    assert float(got) == pytest.approx(want, rel=LOSS_RTOL)
    with ops.use(attention="pallas"):
        assert float(eval_step(state, batch)) == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# microbatches, remat, decay


def test_microbatched_grads_match_full(jax_ref):
    """The reference's ``test_microbatched_grads_match_full`` held in the
    port (loss rel 1e-5, parameters within 5e-5), and the port's 4
    microbatches against the reference's 4."""
    cfg, cfg_j = get_smoke_config("granite_8b"), jax_smoke_config("granite_8b")
    model = build_model(cfg)
    state_j = jax_init_state(jax_build_model(cfg_j).param_specs(), jax.random.PRNGKey(0))
    state, batch = to_torch(state_j), _torch_batch(cfg, 8, 32)
    s1, m1 = make_train_step(model, TrainConfig(microbatches=1))(state, batch)
    s4, m4 = make_train_step(model, TrainConfig(microbatches=4))(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    worst = max(float((a - b).abs().max()) for (_, a), (_, b) in
                zip(named_leaves(s1["params"]), named_leaves(s4["params"])))
    assert worst < 5e-5
    _, m4j = jax.jit(jax_make_train_step(jax_build_model(cfg_j), JTrainConfig(microbatches=4)))(
        state_j, _jax_batch(cfg_j, 8, 32))
    assert float(m4["loss"]) == pytest.approx(float(m4j["loss"]), rel=LOSS_RTOL)
    assert float(m4["grad_norm"]) == pytest.approx(float(m4j["grad_norm"]), rel=1e-5)


@pytest.mark.parametrize("arch", ("granite_8b", "granite_moe_1b_a400m", "mamba2_130m",
                                  "recurrentgemma_2b", "seamless_m4t_large_v2"))
def test_remat_changes_no_bit(arch):
    """Each family's block loop with ``remat`` on against off: the loss and
    every gradient bit-equal."""
    cfg = get_smoke_config(arch)
    batch = _torch_batch(cfg, 2, 16)
    state = init_state(build_model(cfg).param_specs(), 3, device="cpu")
    out = [value_and_grad(build_model(dataclasses.replace(cfg, remat=r)), state["params"], batch)
           for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for (path, a), (_, b) in zip(named_leaves(out[0][1]), named_leaves(out[1][1])):
        assert torch.equal(a, b), path


def test_adamw_decays_stacked_norms_as_the_reference(jax_ref):
    """Property 2: both packages decay a leaf of two or more dimensions, so
    the stacked ``blocks/ln1/scale`` ``[L, d]`` is decayed and only
    ``final_norm/scale`` ``[d]`` escapes."""
    cfg_j = jax_smoke_config("granite_8b")
    params_j = jax_init_state(jax_build_model(cfg_j).param_specs(),
                              jax.random.PRNGKey(0))["params"]
    zeros_j = jax.tree.map(jnp.zeros_like, params_j)
    opt_j = {"mu": zeros_j, "nu": zeros_j}
    step = jnp.asarray(1, jnp.int32)
    new_j, _ = jax_adamw_update(zeros_j, opt_j, params_j, lr=jnp.float32(0.1),
                                cfg=JAdamWConfig(), step=step)
    params, zeros = to_torch(params_j), to_torch(zeros_j)
    new, _ = adamw_update(zeros, {"mu": zeros, "nu": zeros}, params,
                          lr=torch.tensor(0.1), cfg=AdamWConfig(), step=torch.tensor(1))
    moved_j = {"/".join(p) for (p, a), (_, b) in zip(named_leaves(to_torch(new_j)),
                                                    named_leaves(params)) if not torch.equal(a, b)}
    moved = {"/".join(p) for (p, a), (_, b) in zip(named_leaves(new), named_leaves(params))
             if not torch.equal(a, b)}
    assert moved == moved_j
    assert "blocks/ln1/scale" in moved and "final_norm/scale" not in moved
    assert params["blocks"]["ln1"]["scale"].shape == (2, 64)


# ---------------------------------------------------------------------------
# data, schedules, optimizer


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_bit_equal(arch, jax_ref):
    """Every family's batch (with ``patch_embeds`` / ``src_embeds``) at two
    steps and two shards, and the iterator's run of steps."""
    cfg, cfg_j = get_smoke_config(arch), jax_smoke_config(arch)
    dc, dcj = DataConfig(seed=7, noise=0.3), JDataConfig(seed=7, noise=0.3)
    for step, shard in ((0, 0), (5, 1)):
        got = make_batch(cfg, batch=3, seq_len=40, step=step, shard=shard, data_cfg=dc)
        want = jax_make_batch(cfg_j, batch=3, seq_len=40, step=step, shard=shard, data_cfg=dcj)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    it = batch_iterator(cfg, batch=2, seq_len=8, start_step=3)
    for step in (3, 4):
        np.testing.assert_array_equal(next(it)["tokens"], jax_make_batch(
            cfg_j, batch=2, seq_len=8, step=step)["tokens"])


@pytest.mark.parametrize("name", ("cosine_with_warmup", "constant"))
def test_schedules_match_reference(name, jax_ref):
    """At steps 0, 1, warmup - 1, warmup, the middle, total and past it:
    float32 values equal to the reference's (rel 1e-6: the cosine's ulp)."""
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    for s in (0, 1, 9, 10, 11, 55, 100, 130):
        got = float(getattr(tsched, name)(torch.tensor(s, dtype=torch.int32), **kw))
        want = float(getattr(jsched, name)(jnp.asarray(s, jnp.int32), **kw))
        assert got == pytest.approx(want, rel=1e-6, abs=0), s


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
def test_adamw_update_matches_reference(moments, jax_ref):
    """Two AdamW updates of random leaves (a matrix, a stacked [L, d] and a
    vector) with ``moments_dtype`` float32 and bfloat16: parameters within
    0.05 lr, moments in their dtype within one bf16 ulp (float32: 1e-6
    relative)."""
    rng = np.random.default_rng(5)
    shapes = {"w": (8, 16), "stacked": (2, 16), "vec": (16,)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cj, ct = JAdamWConfig(moments_dtype=moments), AdamWConfig(moments_dtype=moments)
    pj, pt = jax.tree.map(jnp.asarray, p), to_torch(p)
    mdt = getattr(jnp, moments)
    oj = {m: jax.tree.map(lambda a: jnp.zeros(a.shape, mdt), pj) for m in ("mu", "nu")}
    ot = {m: to_torch(v) for m, v in oj.items()}
    lr = 0.01
    for step in (1, 2):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        pj, oj = jax_adamw_update(jax.tree.map(jnp.asarray, g), oj, pj, lr=jnp.float32(lr),
                                  cfg=cj, step=jnp.asarray(step, jnp.int32))
        pt, ot = adamw_update(to_torch(g), ot, pt, lr=torch.tensor(lr, dtype=torch.float32),
                              cfg=ct, step=torch.tensor(step, dtype=torch.int32))
        _assert_tree_close(pt, to_torch(pj), "param", atol_of=lambda ref: STEP_FRAC * lr)
        ulp = 2.0 ** -7 if moments == "bfloat16" else 1e-6
        _assert_tree_close(ot, to_torch(oj), "moment",
                           atol_of=lambda ref: ulp * ref.abs().max())
        assert all(t.dtype == getattr(torch, moments) for _, t in named_leaves(ot))


# ---------------------------------------------------------------------------
# checkpoints


def _bf16_state():
    """The reference's granite smoke state after one step with bfloat16
    moments: float32 parameters, bf16 moments, an int32 step."""
    cfg_j = jax_smoke_config("granite_8b")
    adamw = JAdamWConfig(moments_dtype="bfloat16")
    _, _, state, _ = _reference_step(cfg_j, _jax_batch(cfg_j, 2, 16), TC, adamw)
    return state


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
def test_checkpoint_written_by_the_reference_restores_in_the_port(moments, tmp_path, jax_ref):
    if moments == "bfloat16":
        state_j = _bf16_state()
    else:
        cfg_j = jax_smoke_config("granite_8b")
        state_j = _reference_step(cfg_j, _jax_batch(cfg_j, 2, 16), TC)[2]
    jckpt.save(str(tmp_path), 7, state_j)
    template = state_specs(build_model(get_smoke_config("granite_8b")).param_specs(),
                           AdamWConfig(moments_dtype=moments))
    got, step = tckpt.restore(str(tmp_path), template, device="cpu")
    assert step == 7
    want = to_torch(state_j)
    gl, wl = named_leaves(got), named_leaves(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w)), path
    assert got["opt"]["mu"]["embed"]["table"].dtype == getattr(torch, moments)


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
def test_checkpoint_written_by_the_port_is_the_references(moments, tmp_path, jax_ref):
    """The port writes the reference's files byte for byte (every ``.npy``
    and ``index.json``).  The reference restores the float32 one to the
    same leaves.  A bf16 leaf the reference cannot restore from either
    package's file: its ``restore`` hands the loaded 2-byte void items to
    ``jnp.asarray``, which raises ``TypeError`` (ROADMAP.md C)."""
    cfg_j = jax_smoke_config("granite_8b")
    state_j = (_bf16_state() if moments == "bfloat16" else
               _reference_step(cfg_j, _jax_batch(cfg_j, 2, 16), TC)[2])
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    tckpt.save(str(mine), 3, to_torch(state_j))
    jckpt.save(str(theirs), 3, state_j)
    names = sorted(os.listdir(theirs / "step_00000003"))
    assert names == sorted(os.listdir(mine / "step_00000003"))
    match, mismatch, errors = filecmp.cmpfiles(theirs / "step_00000003",
                                               mine / "step_00000003", names, shallow=False)
    assert (mismatch, errors) == ([], [])
    if moments == "bfloat16":
        for d in (mine, theirs):
            with pytest.raises(TypeError, match="V2"):
                jckpt.restore(str(d), state_j)
        return
    restored, step = jckpt.restore(str(mine), state_j)
    assert step == 3
    for (path, a), (_, b) in zip(named_leaves(to_torch(restored)), named_leaves(to_torch(state_j))):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_latest_step_and_rotate_match_reference(tmp_path, jax_ref):
    """Both packages' ``latest_step`` and ``rotate`` over the same
    directory listings: a ``.tmp`` directory and one without ``index.json``
    are never the latest; rotation keeps the newest."""
    tiny = {"w": np.zeros(2, np.float32)}
    for pkg, save in (("port", lambda d, s: tckpt.save(d, s, to_torch(tiny))),
                      ("ref", lambda d, s: jckpt.save(d, s, tiny))):
        d = str(tmp_path / pkg)
        assert tckpt.latest_step(d) is None and jckpt.latest_step(d) is None
        for s in (2, 10, 5, 7):
            save(d, s)
        os.makedirs(os.path.join(d, "step_00000099.tmp"))
        os.makedirs(os.path.join(d, "step_00000050"))  # no index.json: incomplete
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert tckpt.latest_step(port) == jckpt.latest_step(ref) == 10
    tckpt.rotate(port, keep=2)
    jckpt.rotate(ref, keep=2)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert tckpt.latest_step(port) == 10


# ---------------------------------------------------------------------------
# the loop


def test_loss_decreases():
    """The reference's convergence test held in the port: granite's smoke
    config, 40 steps, the mean of the last 5 losses 0.3 below the first 5."""
    res = run_train(get_smoke_config("granite_8b"),
                    TrainConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60),
                    LoopConfig(num_steps=40, batch=8, seq_len=64, log_every=100),
                    device="cpu", **QUIET)
    first = np.mean([h["loss"] for h in res["history"][:5]])
    last = np.mean([h["loss"] for h in res["history"][-5:]])
    assert last < first - 0.3, (first, last)
    assert all(h["seconds"] > 0 for h in res["history"])


def test_crash_restart_resumes_bitwise(tmp_path):
    """An injected crash at step 8 of a 12-step run checkpointing every 5
    steps, then a resume from step 5: the uninterrupted run's final loss
    and parameters, bit for bit (CPU arithmetic is deterministic)."""
    cfg = get_smoke_config("granite_8b")
    tc = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    lc = LoopConfig(num_steps=12, batch=4, seq_len=32, ckpt_dir=str(tmp_path), ckpt_every=5,
                    log_every=100)
    ref = run_train(cfg, tc, dataclasses.replace(lc, ckpt_dir=None), device="cpu", **QUIET)
    with pytest.raises(RuntimeError, match="injected failure at step 8"):
        run_train(cfg, tc, lc, failure_injector=FailureInjector(fail_at_step=8),
                  device="cpu", **QUIET)
    assert tckpt.latest_step(str(tmp_path)) == 5
    logs = []
    res = run_train(cfg, tc, lc, device="cpu", log_fn=logs.append)
    assert "[loop] resumed from step 5" in logs
    assert res["final_step"] == 12 and len(res["history"]) == 7
    assert res["history"][-1]["loss"] == ref["history"][-1]["loss"]
    for (path, a), (_, b) in zip(named_leaves(res["state"]), named_leaves(ref["state"])):
        assert torch.equal(a, b), path


def test_preemption_checkpoint(tmp_path):
    """SIGTERM mid-run: the loop checkpoints and stops early."""
    sent = {"done": False}

    def log_and_preempt(msg):
        if not sent["done"] and "step" in msg:
            sent["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    res = run_train(get_smoke_config("granite_8b"), TrainConfig(),
                    LoopConfig(num_steps=50, batch=4, seq_len=32, ckpt_dir=str(tmp_path),
                               ckpt_every=1000, log_every=1),
                    log_fn=log_and_preempt, device="cpu")
    assert res["final_step"] < 50
    assert tckpt.latest_step(str(tmp_path)) == res["final_step"]
    assert signal.getsignal(signal.SIGTERM) == handler


def test_straggler_watchdog_matches_reference(jax_ref):
    """The reference's watchdog test, and both watchdogs over one sequence
    of step times: the same verdicts, events and EMA."""
    w = StragglerWatchdog(threshold=2.0, warmup=2)
    for _ in range(5):
        assert not w.observe(0.10)
    assert w.observe(0.50)
    assert len(w.events) == 1 and w.ema == pytest.approx(0.10, rel=0.2)
    times = np.random.default_rng(6).gamma(2.0, 0.05, 60)
    times[[10, 11, 30, 45]] *= 8
    a, b = StragglerWatchdog(threshold=2.5), JWatchdog(threshold=2.5)
    assert [a.observe(float(t), i) for i, t in enumerate(times)] == [
        b.observe(float(t), i) for i, t in enumerate(times)]
    assert a.events == b.events and a.ema == b.ema and len(a.events) >= 3


def test_mesh_raises_the_named_error():
    """A mesh whose device count is not the process group's world size
    raises ``MeshShapeError``, never a run on fewer devices; no mesh is
    built without a process group; a device other than the mesh's is
    refused."""
    from repro_torch.launch import train as launch

    with pytest.raises(MeshShapeError, match="needs 2 ranks, the process group has 1"):
        launch.main(["--arch", "granite_8b", "--smoke", "--mesh", "2,1", "--device", "cpu"])
    assert not torch.distributed.is_initialized()  # the launcher tore its group down
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh((1, 1), ("data", "model"), "cpu")

    class CpuMesh:
        device_type = "cpu"

    with pytest.raises(ValueError, match="not the mesh's"):
        run_train(get_smoke_config("granite_8b"), mesh=CpuMesh(), device="meta", **QUIET)
    assert issubclass(MeshShapeError, ValueError)


def test_entry_points_need_the_card_unless_asked(monkeypatch, tmp_path):
    """The loop, the state and a restore default to the card and raise
    without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("granite_8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_train(cfg, LoopConfig(num_steps=1), **QUIET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(build_model(cfg).param_specs())
    tckpt.save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(str(tmp_path), {"w": None})


def test_launcher_trains_and_refuses_a_mesh(capsys, monkeypatch):
    """The launcher trains on one device and on a one-rank ``--mesh 1,1``
    (the same loss: every leaf of the state is a DTensor on the mesh, but
    one rank holds all of it), and refuses a mesh the world cannot hold and
    a ``--multihost`` without torchrun's environment."""
    from repro_torch.launch import train as launch

    base = ["--arch", "bert_base_star", "--smoke", "--steps", "3", "--seq", "32",
            "--device", "cpu"]
    finals = []
    for extra in ([], ["--mesh", "1,1"]):
        assert launch.main(base + extra) == 0
        out = capsys.readouterr().out
        assert out.strip().splitlines()[-1].startswith("final loss: ")
        assert out.strip().endswith("after 3 steps")
        finals.append(out.strip().splitlines()[-1])
    assert finals[0] == finals[1]
    assert not torch.distributed.is_initialized()
    with pytest.raises(MeshShapeError, match="needs 2 ranks"):
        launch.main(["--arch", "granite_8b", "--smoke", "--mesh", "2,1", "--device", "cpu"])
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK"):
        launch.main(["--arch", "granite_8b", "--smoke", "--multihost", "--device", "cpu"])


# ---------------------------------------------------------------------------
# bert-base-star


def test_bert_base_star_configs_follow_the_reference(jax_ref):
    """Config and smoke config field for field (``softmax`` as the same
    resolved spec), ~132.1 M parameters in both packages, D 64, the
    softmax precision ``"auto:cnews"`` resolving to CNEWS' 6i.2f."""
    for mine, ref in ((get_config("bert_base_star"), jax_config("bert_base_star")),
                      (get_smoke_config("bert_base_star"), jax_smoke_config("bert_base_star"))):
        for f in dataclasses.fields(mine):
            if f.name not in ("softmax", "attention"):
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        s, r = mine.softmax_spec, ref.softmax_spec
        assert (s.kind, s.mode, s.precision, s.impl) == (r.kind, r.mode, r.precision, r.impl)
        assert (s.fmt.int_bits, s.fmt.frac_bits) == (r.fmt.int_bits, r.fmt.frac_bits)
        assert s.fmt == FORMAT_CNEWS
    full = get_config("bert_base_star")
    n = count_params(build_model(full).param_specs())
    assert n == jax_count_params(jax_build_model(jax_config("bert_base_star")).param_specs())
    assert 132.0e6 < n < 132.2e6 and full.resolved_head_dim == 64 and full.remat
    assert (full.attention_spec.impl, full.padded_vocab) == ("xla", 30720)


def test_bert_smoke_greedy_lockstep_tokens_match_reference(jax_ref):
    cfg_j = jax_smoke_config("bert_base_star")
    params_j = jax_init_state(jax_build_model(cfg_j).param_specs(),
                              jax.random.PRNGKey(0))["params"]
    prompts = np.random.default_rng(7).integers(0, 256, (3, 9)).astype(np.int32)
    want, info_j = JaxServeEngine(cfg_j, params_j, JaxServeConfig(max_len=40)).generate(
        jnp.asarray(prompts), 12)
    cfg = dataclasses.replace(get_smoke_config("bert_base_star"), attn_impl="pallas")
    with ops.use(softmax="pallas"):
        eng = ServeEngine(cfg, to_torch(params_j), ServeConfig(max_len=40), device="cpu")
        got, info = eng.generate(prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert info == info_j


# ---------------------------------------------------------------------------
# the histogram denominator in the kernel's order


def _butterfly(vals):
    """A warp's ``__shfl_xor`` butterfly on lane 0, one float32 add a step."""
    v = [np.float32(x) for x in vals] + [np.float32(0)] * (32 - len(vals))
    for o in (16, 8, 4, 2, 1):
        v = [np.float32(v[lane] + v[lane ^ o]) for lane in range(32)]
    return v[0]


@pytest.mark.parametrize("levels", (128, 256, 512))
def test_histogram_denominator_sums_in_the_kernel_order(levels):
    """``kernel_order_dot`` against a scalar emulation of the kernel's
    histogram denominator: 256 threads, thread ``t`` adding the rounded
    products of levels ``t, t + 256, ...``, then ``block_sum`` (each warp's
    butterfly, then the 8 warp sums' butterfly); and the clean histogram
    plain version within an ulp of the reference engine's ``counts @
    lut``."""
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.star_softmax import star_softmax
    from repro_torch.kernels.star_softmax.kernel import NT, kernel_order_dot, star_softmax_ref

    rng = np.random.default_rng(levels)
    counts = rng.integers(0, 3000, (3, levels)).astype(np.float32)
    vmm = np.exp(-np.arange(levels) / 4.0).astype(np.float32)
    got = kernel_order_dot(torch.from_numpy(counts), torch.from_numpy(vmm)).numpy()
    for row in range(3):
        part = [np.float32(0)] * NT
        for lvl in range(levels):
            part[lvl % NT] = np.float32(part[lvl % NT] + np.float32(counts[row, lvl] * vmm[lvl]))
        warps = [_butterfly(part[w * 32:(w + 1) * 32]) for w in range(NT // 32)]
        assert got[row] == _butterfly(warps)
    fmt = FixedPointFormat(6, {128: 1, 256: 2, 512: 3}[levels])
    x = torch.from_numpy(rng.normal(0, 4, (4, 3000)).astype(np.float32))
    torch.testing.assert_close(star_softmax_ref(x, fmt, mode="histogram"),
                               star_softmax(x, fmt, mode="histogram"), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# on the card: the kernels at the trained bert-base-star's shapes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_star_float32_at_bert_shapes_matches_plain_on_card(cuda):
    """flash_star's float32 kernel at head_dim 64, one q head per KV head
    (causal prefill and a ragged batch), STAR and exact, against its plain
    version within chip_smoke's float32 tolerance, a row outside it only at
    a score near a grid half-step."""
    from repro_torch.kernels.flash_star import flash_star_attention
    from repro_torch.kernels.flash_star.ref import flash_star_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 12, 256, 64, device=cuda, generator=gen) for _ in range(3))
    info = torch.tensor([0, 256, 200], dtype=torch.int32, device=cuda)
    for fmt in (FORMAT_CNEWS, None):
        with torch.no_grad():
            got = flash_star_attention(q, k, v, info, fmt=fmt, causal=True)
            want = flash_star_ref(q, k, v, info, fmt=fmt, causal=True)
        bad = ((got - want).abs() > 5e-5 + 1e-4 * want.abs()).any(-1)
        assert int(bad.sum()) <= 2, int(bad.sum())


@pytest.mark.cuda
def test_star_softmax_histogram_at_bert_vocab_bit_equal_on_card(cuda):
    """The STAR softmax in histogram mode (the config's) at the sampling row
    of bert-base-star, [4, 30720] with the 198 padded columns at -1e30, and
    at [4, 30522]: bit-equal to its plain version."""
    from repro_torch.kernels.star_softmax import star_softmax_kernel
    from repro_torch.kernels.star_softmax.kernel import star_softmax_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    for cols, pad in ((30720, 198), (30522, 0)):
        x = torch.randn(4, cols, device=cuda, generator=gen) * 4
        if pad:
            x[:, cols - pad:] = -1e30
        got = star_softmax_kernel(x, FORMAT_CNEWS, mode="histogram")
        assert torch.equal(got, star_softmax_ref(x, FORMAT_CNEWS, mode="histogram"))
