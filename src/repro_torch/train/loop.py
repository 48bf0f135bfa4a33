"""The training loop (port of ``repro.train.loop``): checkpoint and
restart, preemption, the straggler watchdog, on one device or sharded over a
mesh.

It resumes from the newest checkpoint in ``ckpt_dir`` if there is one,
checkpoints every ``ckpt_every`` steps, at the end and on SIGTERM, keeps
the ``keep_ckpts`` newest, and times every step on the host clock (the
step's metrics are read back, which waits for the device).

Given a ``mesh`` (``launch.mesh.make_mesh``) and ``rules`` (default
``DEFAULT_RULES``), the state (drawn from the seed, or restored) is
distributed by ``param_shardings``: every leaf a DTensor on the mesh.  Each
batch is sharded by the ``"batch"`` rule and the step runs under
``use_mesh_rules``, so the model's logical constraints place its
activations and DTensor inserts the collectives.  Every rank runs the loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.distributed.fault import FailureInjector, PreemptionGuard, StragglerWatchdog
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    Rules,
    distribute,
    is_dtensor,
    param_shardings,
    sharding_of,
    use_mesh_rules,
)
from repro_torch.models.registry import build_model
from repro_torch.ops.platform import Device, resolve_device
from repro_torch.train.state import init_state, state_specs
from repro_torch.train.step import TrainConfig, make_train_step


@dataclasses.dataclass
class LoopConfig:
    num_steps: int = 20
    batch: int = 8
    seq_len: int = 64
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    keep_ckpts: int = 3
    log_every: int = 5
    seed: int = 0
    straggler_threshold: float = 2.5


def run_train(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig = TrainConfig(),
    loop_cfg: LoopConfig = LoopConfig(),
    *,
    mesh=None,
    rules: Optional[Rules] = None,
    data_cfg: DataConfig = DataConfig(),
    failure_injector: Optional[FailureInjector] = None,
    log_fn: Callable[[str], None] = print,
    device: Device = None,
) -> Dict[str, Any]:
    """Train on ``device`` (default the card), or sharded over ``mesh`` (on
    the mesh's device); resume from ``loop_cfg.ckpt_dir`` if it holds a
    checkpoint.  ``rules`` without a mesh change nothing, as in the
    reference.

    Returns ``{"state", "history", "stragglers", "final_step"}``; each
    history entry holds the step, its ``loss``, ``grad_norm`` and ``lr``,
    and its host-clock ``seconds``."""
    if mesh is not None:
        dev = torch.device(mesh.device_type)
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"device {device!r} is not the mesh's {mesh.device_type!r}")
    else:
        dev = resolve_device(device)
    rules = rules or DEFAULT_RULES
    model = build_model(model_cfg)
    specs = model.param_specs()
    sspecs = state_specs(specs, train_cfg.adamw)
    shardings = param_shardings(sspecs, rules, mesh) if mesh is not None else None
    step_fn = make_train_step(model, train_cfg)

    start_step = 0
    state = None
    if loop_cfg.ckpt_dir and checkpointer.latest_step(loop_cfg.ckpt_dir) is not None:
        state, start_step = checkpointer.restore(loop_cfg.ckpt_dir, sspecs, device=dev,
                                                 shardings=shardings)
        log_fn(f"[loop] resumed from step {start_step}")
    if state is None:
        state = init_state(specs, loop_cfg.seed, train_cfg.adamw, dev)
        if shardings is not None:
            state = distribute(state, shardings)

    def place(x: torch.Tensor) -> torch.Tensor:
        x = torch.from_numpy(x).to(dev)
        if mesh is None:
            return x
        return sharding_of(("batch",) + (None,) * (x.ndim - 1), x.shape, rules, mesh).place(x)

    watchdog = StragglerWatchdog(threshold=loop_cfg.straggler_threshold)
    history = []
    with use_mesh_rules(mesh, rules), PreemptionGuard() as guard:
        step = start_step
        while step < loop_cfg.num_steps:
            if failure_injector is not None:
                failure_injector.maybe_fail(step)
            batch_np = make_batch(model_cfg, batch=loop_cfg.batch, seq_len=loop_cfg.seq_len,
                                  step=step, data_cfg=data_cfg)
            batch = {k: place(v) for k, v in batch_np.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            metrics = {k: _host(v) for k, v in metrics.items()}  # waits for the device
            dt = time.perf_counter() - t0
            straggler = watchdog.observe(dt, step)
            step += 1
            history.append({"step": step, **metrics, "seconds": dt})
            if step % loop_cfg.log_every == 0 or step == loop_cfg.num_steps:
                log_fn(
                    f"[loop] step {step} loss {history[-1]['loss']:.4f} "
                    f"gnorm {history[-1]['grad_norm']:.3f} dt {dt*1e3:.0f}ms"
                    + (" STRAGGLER" if straggler else "")
                )
            want_ckpt = loop_cfg.ckpt_dir and (
                step % loop_cfg.ckpt_every == 0
                or step == loop_cfg.num_steps
                or guard.requested
            )
            if want_ckpt:
                checkpointer.save(loop_cfg.ckpt_dir, step, state)
                checkpointer.rotate(loop_cfg.ckpt_dir, loop_cfg.keep_ckpts)
            if guard.requested:
                log_fn(f"[loop] preemption requested; checkpointed at {step}")
                break

    return {"state": state, "history": history, "stragglers": watchdog.events,
            "final_step": step}


def _host(v) -> float:
    return float(v.full_tensor() if is_dtensor(v) else v)
