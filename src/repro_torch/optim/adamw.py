"""AdamW with float32 moments by default (port of ``repro.optim.adamw``).

Every update is computed in float32 as the reference computes it (``b1 **
t`` as a float32 tensor, moments cast to ``moments_dtype``), and decay
follows the reference's rule exactly: a leaf of two or more dimensions is
decayed, a vector is not.  The per-layer norm scales are stacked ``[L, d]``
leaves, so they are decayed; only the final norm's scale (``[d]``) is not.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models.param import ParamSpec, named_leaves, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # float32 moments by default; "bfloat16" halves the optimizer state
    moments_dtype: str = "float32"


def opt_state_specs(param_specs: Params, cfg: AdamWConfig = AdamWConfig()) -> Params:
    """Spec tree of the moments: zeros of each parameter's shape in
    ``moments_dtype``."""
    mdt = getattr(torch, cfg.moments_dtype)

    def moments():
        return tree_map(lambda s: ParamSpec(s.shape, s.axes, mdt, "zeros"), param_specs)

    return {"mu": moments(), "nu": moments()}


def init_opt_state(params: Params, cfg: AdamWConfig = AdamWConfig()) -> Params:
    mdt = getattr(torch, cfg.moments_dtype)

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params)

    return {"mu": zeros(), "nu": zeros()}


def adamw_update(grads: Params, opt_state: Params, params: Params, *, lr: torch.Tensor,
                 cfg: AdamWConfig, step: torch.Tensor) -> Tuple[Params, Params]:
    """``(new_params, new_opt_state)`` for the 1-based ``step``."""
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    mdt = getattr(torch, cfg.moments_dtype)

    def upd(g, mu, nu, p):
        g32 = g.float()
        mu32 = b1 * mu.float() + (1 - b1) * g32
        nu32 = b2 * nu.float() + (1 - b2) * (g32 * g32)
        delta = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:  # no decay on vectors (the final norm)
            delta = delta + cfg.weight_decay * p.float()
        newp = (p.float() - lr * delta).to(p.dtype)
        return newp, mu32.to(mdt), nu32.to(mdt)

    out = tree_map(upd, grads, opt_state["mu"], opt_state["nu"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), {"mu": pick(1), "nu": pick(2)}


def global_norm(tree: Params) -> torch.Tensor:
    """The float32 L2 norm of every leaf together."""
    sums = [torch.sum(torch.square(x.float())) for _, x in named_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    """``(tree scaled so its global norm is at most max_norm, the norm before)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm
