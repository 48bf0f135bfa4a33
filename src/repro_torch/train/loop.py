"""The training loop on one device (port of ``repro.train.loop``):
checkpoint and restart, preemption, the straggler watchdog.

It resumes from the newest checkpoint in ``ckpt_dir`` if there is one,
checkpoints every ``ckpt_every`` steps, at the end and on SIGTERM, keeps
the ``keep_ckpts`` newest, and times every step on the host clock (the
step's metrics are read back, which waits for the device).  Sharded
training over a device mesh is not ported: ``mesh=`` or ``rules=`` raise
:class:`MeshNotPortedError`, never a run on one device instead.
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
from repro_torch.models.registry import build_model
from repro_torch.ops.platform import Device, resolve_device
from repro_torch.train.state import init_state, state_specs
from repro_torch.train.step import TrainConfig, make_train_step


class MeshNotPortedError(NotImplementedError):
    """Sharded training over a device mesh (the reference's ``mesh`` /
    ``rules``, its ``distributed/`` and ``launch/mesh.py``) is not ported:
    the port trains on one device (ROADMAP.md A.9)."""


def refuse_mesh(what: str) -> None:
    raise MeshNotPortedError(
        f"{what}: sharded training over a device mesh is not ported; the port trains on "
        f"one device (ROADMAP.md A.9, the mesh code)")


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
    rules=None,
    data_cfg: DataConfig = DataConfig(),
    failure_injector: Optional[FailureInjector] = None,
    log_fn: Callable[[str], None] = print,
    device: Device = None,
) -> Dict[str, Any]:
    """Train on ``device`` (default the card); resume from
    ``loop_cfg.ckpt_dir`` if it holds a checkpoint.

    Returns ``{"state", "history", "stragglers", "final_step"}``; each
    history entry holds the step, its ``loss``, ``grad_norm`` and ``lr``,
    and its host-clock ``seconds``."""
    if mesh is not None or rules is not None:
        refuse_mesh("run_train(mesh=..., rules=...)")
    dev = resolve_device(device)
    model = build_model(model_cfg)
    specs = model.param_specs()
    step_fn = make_train_step(model, train_cfg)

    start_step = 0
    state = None
    if loop_cfg.ckpt_dir and checkpointer.latest_step(loop_cfg.ckpt_dir) is not None:
        state, start_step = checkpointer.restore(
            loop_cfg.ckpt_dir, state_specs(specs, train_cfg.adamw), device=dev)
        log_fn(f"[loop] resumed from step {start_step}")
    if state is None:
        state = init_state(specs, loop_cfg.seed, train_cfg.adamw, dev)

    watchdog = StragglerWatchdog(threshold=loop_cfg.straggler_threshold)
    history = []
    with PreemptionGuard() as guard:
        step = start_step
        while step < loop_cfg.num_steps:
            if failure_injector is not None:
                failure_injector.maybe_fail(step)
            batch_np = make_batch(model_cfg, batch=loop_cfg.batch, seq_len=loop_cfg.seq_len,
                                  step=step, data_cfg=data_cfg)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
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
