"""Explicit collectives: the int8 error-feedback gradient all-reduce (port
of ``repro.distributed.collectives``).

The sharded train step lets DTensor insert the gradient reductions; this is
the explicit alternative for a bandwidth-bound mesh dim.  Every rank of the
dim quantizes its gradient plus its carried error on one shared grid (the
dim's absmax over 127), the int8 codes go over the wire, and each rank sums
them exactly in int32 and scales back; what the rounding dropped stays in
the rank's error and is added to its next gradient.  The result is the
reference's ``_ef_compress_allreduce`` on every rank: integer sums are exact
in any order.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.param import tree_map

Params = Any


def _ef_compress_allreduce(x: torch.Tensor, err: torch.Tensor, group) -> Tuple[torch.Tensor,
                                                                               torch.Tensor]:
    """``(mean, new_err)`` of one tensor over ``group``."""
    xf = x.float() + err
    amax = xf.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    new_err = xf - q * scale
    n = dist.get_world_size(group)
    codes = [torch.empty_like(q, dtype=torch.int8) for _ in range(n)]
    dist.all_gather(codes, q.to(torch.int8).contiguous(), group=group)
    total = torch.stack(codes).to(torch.int32).sum(dim=0).float()
    return (total * scale / n).to(x.dtype), new_err


def compressed_grad_allreduce(grads: Params, err: Params, mesh, axis: str = "data"
                              ) -> Tuple[Params, Params]:
    """Each rank's gradient tree (plain tensors: the rank's own gradient)
    and its error tree -> ``(mean over the mesh dim axis, new error)``.
    Every rank of the dim must call it with the same tree structure."""
    group = mesh.get_group(axis)
    pairs = tree_map(lambda g, e: _ef_compress_allreduce(g, e, group), grads, err)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def init_error_state(grads_like: Params) -> Params:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_like)
