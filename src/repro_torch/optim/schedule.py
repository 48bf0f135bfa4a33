"""Learning-rate schedules (port of ``repro.optim.schedule``): functions of
a step tensor, computed in float32 as the reference computes them."""

from __future__ import annotations

import math

import torch


def cosine_with_warmup(step: torch.Tensor, *, peak_lr: float, warmup: int, total: int,
                       floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor * peak_lr`` at ``total``."""
    s = step.float()
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(step.float(), peak_lr)
