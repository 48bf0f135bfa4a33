"""Train and eval steps (port of ``repro.train.step``): gradients by
``torch.autograd`` over ``model.loss``, microbatches accumulated in float32,
clipping by the global norm, AdamW.

The reference's ``lax.scan`` over microbatches (``core.scan_ctl``'s
switch between scanning and unrolling) is a Python loop here: eager
PyTorch has only the unrolled form, so the port keeps no counterpart of
``scan_ctl``.

A parameter that the loss does not reach (Q / K weights under STAR on the
online-blocked route, whose grid snap has no gradient) gets a zero
gradient, as ``jax.grad`` gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.param import named_leaves, tree_map, unflatten
from repro_torch.optim import schedule as schedule_lib
from repro_torch.optim.adamw import AdamWConfig, adamw_update, clip_by_global_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | constant
    grad_clip: float = 1.0
    microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()


def value_and_grad(model, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Params]:
    """``(loss, d loss / d params)``: the gradient tree has the parameters'
    structure and dtypes, zeros where the loss does not depend on a leaf."""
    paths, leaves = zip(*named_leaves(params))
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss(unflatten(paths, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), unflatten(paths, grads)


def make_train_step(model, train_cfg: TrainConfig) -> Callable:
    """``train_step(state, batch) -> (new_state, {"loss", "grad_norm",
    "lr"})``.  ``batch`` holds tensors on the state's device; with
    ``microbatches`` > 1 it is split along the batch axis into that many
    contiguous pieces, their losses and float32 gradients averaged in order
    and the gradients cast back to each parameter's dtype, as the reference
    does."""
    sched = {"cosine": schedule_lib.cosine_with_warmup,
             "constant": schedule_lib.constant}[train_cfg.schedule]
    mb = train_cfg.microbatches

    def grads_of(params, batch):
        if mb <= 1:
            return value_and_grad(model, params, batch)
        micro = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        dev = next(iter(batch.values())).device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        for i in range(mb):
            li, gi = value_and_grad(model, params, {k: v[i] for k, v in micro.items()})
            loss = loss + li / mb
            grads = tree_map(lambda a, g: a + g.float() / mb, grads, gi)
        return loss, tree_map(lambda g, p: g.to(p.dtype), grads, params)

    def train_step(state: Params, batch: Dict[str, torch.Tensor]):
        loss, grads = grads_of(state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        step1 = state["step"] + 1
        lr = sched(step1, peak_lr=train_cfg.peak_lr, warmup=train_cfg.warmup_steps,
                   total=train_cfg.total_steps)
        new_params, new_opt = adamw_update(grads, state["opt"], state["params"], lr=lr,
                                           cfg=train_cfg.adamw, step=step1)
        new_state = {"params": new_params, "opt": new_opt, "step": step1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_eval_step(model) -> Callable:
    """``eval_step(state, batch) -> loss``, under ``torch.no_grad()``."""

    def eval_step(state: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(state["params"], batch)

    return eval_step
