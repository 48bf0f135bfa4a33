"""The plain version of the STAR softmax kernel (port of
``repro.kernels.star_softmax.ref``): the reference engine
``core.star_softmax`` with the row's numerators, and the histogram mode's
VMM dot, added in the order the CUDA kernel adds them, so a clean call is
bit for bit the kernel's on any device.  The cluster geometry that fixes
that order (``cluster_size``, ``slice_len``, ``NT``) lives here too; the
kernel module imports it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fixedpoint import DEFAULT_FORMAT, FixedPointFormat
from repro_torch.core.star_softmax import star_softmax
from repro_torch.hwmodel.faults import FaultModel

CLUSTER_MAX = 8  # CTAs a row: the portable cluster size
SLICE_TARGET = 4096  # columns a CTA takes before a row is split over more
SLICE_ALIGN = 8  # slices start on 16 bytes of float32 or bfloat16 x
NT = 256  # the kernel's threads a CTA (``NT`` in the source)
WARP = 32


def cluster_size(d: int) -> int:
    """CTAs of the cluster that owns a row of ``d`` columns: one up to
    ``SLICE_TARGET``, one more per ``SLICE_TARGET``, at most ``CLUSTER_MAX``."""
    return max(1, min(CLUSTER_MAX, -(-d // SLICE_TARGET)))


def slice_len(d: int, cluster: int) -> int:
    """Columns of each CTA's slice: ``d / cluster`` rounded up to
    ``SLICE_ALIGN``; the last slice takes what is left."""
    per_cta = -(-d // cluster)
    return -(-per_cta // SLICE_ALIGN) * SLICE_ALIGN


def kernel_order_sum(p: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
    """Sums over the last axis of ``p`` ``[..., d]`` (float32), keepdim, in
    the order the kernel adds a row's numerators for an input of
    ``x_dtype``: rank ``q`` of the row's cluster takes columns ``[q * slice,
    (q + 1) * slice)``; thread ``t`` of a CTA adds, from 0, the elements
    ``(g * NT + t) * V + e`` of its slice (``V`` of them in 16 bytes of x)
    for ``g``, then ``e``, ascending; a warp adds its lanes' partials by the
    butterfly (lane ``l`` + lane ``l + o`` for ``o`` = 16 .. 1), the CTA its
    warps' the same way, and the row its ranks' partials in rank order,
    from 0.  Every step is one float32 addition, so the result is the
    kernel's on any device."""
    d = p.shape[-1]
    rows = p.reshape(-1, d)
    n = rows.shape[0]
    c = cluster_size(d)
    s = slice_len(d, c)
    v = 16 // x_dtype.itemsize if x_dtype in (torch.float32, torch.bfloat16) else 4
    span = NT * v
    groups = -(-s // span)
    sliced = torch.nn.functional.pad(rows, (0, c * s - d)).reshape(n, c, s)
    t = torch.nn.functional.pad(sliced, (0, groups * span - s)).reshape(n, c, groups, NT, v)
    part = torch.zeros((n, c, NT), dtype=p.dtype, device=p.device)
    for g in range(groups):
        for e in range(v):
            part = part + t[:, :, g, :, e]
    warps = _block_sum(part)
    den = torch.zeros((n,), dtype=p.dtype, device=p.device)
    for q in range(c):
        den = den + warps[:, q]
    return den.reshape(p.shape[:-1] + (1,))


def _block_sum(part: torch.Tensor) -> torch.Tensor:
    """The kernel's ``block_sum`` of ``[..., NT]`` thread partials: a warp
    adds its lanes by the butterfly (lane ``l`` + lane ``l + o``, ``o`` = 16
    .. 1), then the warps' sums the same way.  ``[...]``."""
    lanes = part.reshape(part.shape[:-1] + (NT // WARP, WARP))
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    warps = lanes[..., 0]
    o = NT // WARP // 2
    while o:
        warps = warps[..., :o] + warps[..., o:2 * o]
        o //= 2
    return warps[..., 0]


def kernel_order_dot(counts: torch.Tensor, vmm: torch.Tensor) -> torch.Tensor:
    """The histogram mode's denominator ``sum_l counts[..., l] * vmm[l]``
    (float32 ``[...]``) in the kernel's order: thread ``t`` adds, from 0, the
    rounded products of levels ``t, t + NT, ...`` ascending, then
    ``block_sum``.  Every CTA of the cluster forms it alike from the
    cluster's summed counts, so it is the kernel's on any device."""
    levels = counts.shape[-1]
    prod = counts.float() * vmm.float()
    rounds = -(-levels // NT)
    prod = torch.nn.functional.pad(prod, (0, rounds * NT - levels))
    prod = prod.reshape(prod.shape[:-1] + (rounds, NT))
    part = torch.zeros(prod.shape[:-2] + (NT,), dtype=torch.float32, device=prod.device)
    for r in range(rounds):
        part = part + prod[..., r, :]
    return _block_sum(part)


def star_softmax_ref(x: torch.Tensor, fmt: FixedPointFormat = DEFAULT_FORMAT, *,
                     mode: str = "gather", fault: Optional[FaultModel] = None) -> torch.Tensor:
    """The plain version of the kernel: the reference engine, the row sum
    of ``gather`` / ``onehot`` mode and the ``histogram`` mode's VMM dot
    taken in the kernel's order (so a clean call is bit for bit the
    kernel's; a faulty histogram divides by the ADC gain before the row
    where the kernel's wrapper divides after it: an ulp)."""
    return star_softmax(x, fmt, mode=mode, fault=fault, dtype=torch.float32,
                        row_sum=lambda num: kernel_order_sum(num, x.dtype),
                        vmm_dot=kernel_order_dot)


def exact_softmax_ref(x: torch.Tensor) -> torch.Tensor:
    """The exact softmax over the last axis, in float32."""
    return torch.softmax(x.float(), dim=-1)
