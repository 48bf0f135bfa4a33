"""The train state: parameters, AdamW moments and the step (port of
``repro.train.state``).  The tree is the reference's: ``{"params", "opt":
{"mu", "nu"}, "step"}``, so a state converts leaf by leaf and a checkpoint
of either package restores in the other."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.param import ParamSpec, materialize
from repro_torch.ops.platform import Device, resolve_device
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, opt_state_specs

Params = Dict[str, Any]


def state_specs(param_specs: Params, adamw: AdamWConfig = AdamWConfig()) -> Params:
    """Spec tree of the whole train state."""
    return {
        "params": param_specs,
        "opt": opt_state_specs(param_specs, adamw),
        "step": ParamSpec((), (), torch.int32, "zeros"),
    }


def init_state(param_specs: Params, seed: int = 0, adamw: AdamWConfig = AdamWConfig(),
               device: Device = None) -> Params:
    """Parameters drawn from ``seed`` (``models.param.materialize``: the
    port's own draws, not the reference's), zero moments, step 0, on
    ``device`` (default the card)."""
    dev = resolve_device(device)
    params = materialize(param_specs, seed, dev)
    return {
        "params": params,
        "opt": init_opt_state(params, adamw),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
