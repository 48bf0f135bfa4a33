"""GPipe pipeline parallelism over a mesh dim (port of
``repro.distributed.pipeline_parallel``).

Stage-stacked block parameters ``[S, ...]``: rank ``i`` of the ``stage``
dim runs stage ``i``.  ``M`` microbatches stream through in ``M + S - 1``
ticks: at tick ``t`` stage 0 takes microbatch ``t``, every stage runs its
block, the last stage keeps microbatch ``t - (S - 1)``, and each stage's
buffer moves to the next stage on a ring (``batch_isend_irecv``).  The
bubble is the standard ``(S - 1) / (M + S - 1)``.  The outputs are then
summed over the dim with every stage but the last contributing zeros, as
the reference's ``psum``: every rank returns them, bit for bit the last
stage's.

``block_fn(h, block_params) -> h`` is the caller's, so any family's blocks
pipeline without change.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.param import tree_map

Params = Any


def _shift(buf: torch.Tensor, group, idx: int, s: int) -> torch.Tensor:
    """``buf`` sent to stage ``idx + 1``; returns what stage ``idx - 1``
    sent (a ring)."""
    if s == 1:
        return buf
    nxt = dist.get_global_rank(group, (idx + 1) % s)
    prv = dist.get_global_rank(group, (idx - 1) % s)
    out = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf.contiguous(), nxt, group),
           dist.P2POp(dist.irecv, out, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def pipeline_apply(block_fn: Callable[[torch.Tensor, Params], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, mesh, axis: str = "stage"
                   ) -> torch.Tensor:
    """Run ``x`` ``[M, mb, ...]`` (the same on every rank) through the ``S``
    stages whose parameters ``stage_params`` stacks on its leaves' dim 0.
    Returns ``[M, mb, ...]`` on every rank."""
    group = mesh.get_group(axis)
    s = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    m = x.shape[0]
    params = tree_map(lambda w: w[idx], stage_params)
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m + s - 1):
        if idx == 0 and t < m:
            buf = x[t]
        buf = block_fn(buf, params)
        out_t = t - (s - 1)
        if idx == s - 1 and 0 <= out_t < m:
            outs[out_t] = buf
        buf = _shift(buf, group, idx, s)
    if idx != s - 1:
        outs.zero_()
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs
