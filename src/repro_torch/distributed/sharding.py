"""Logical-axis sharding rules over a ``torch.distributed`` device mesh (port
of ``repro.distributed.sharding``).

Models name the dims of parameters and activations with *logical* axes
("embed", "mlp", "heads", "vocab", "expert", "batch", ...).  A rule table
maps logical axes to mesh dims; :func:`logical_to_pspec` resolves them with
the reference's two rails:

  * **divisibility auto-drop**: a logical axis whose dim is not divisible
    by the mapped mesh dims is left unsharded (8 KV heads on a 16-way model
    dim stay replicated);
  * **single-use**: a mesh dim appears once per spec; later dims drop it
    (an expert dim and an mlp dim both wanting "model").

A spec is the reference's ``PartitionSpec`` entries as a tuple: one entry a
tensor dim, ``None``, a mesh dim's name or a tuple of names.
:func:`placements` turns it into DTensor placements, one a mesh dim:
``Shard(d)`` or ``Replicate()``.

``use_mesh_rules`` installs an ambient ``(mesh, rules)`` so layer code can
call :func:`with_logical_constraint` without threading the mesh through;
outside it the constraint is the identity.  Inside it a plain tensor that
meets a DTensor counts as replicated (``implicit_replication``), as an
unsharded array does under the reference's ``jit``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.param import tree_map

# Rule value: a mesh dim name, a tuple of names, or None.
Rules = Dict[str, Any]
PSpec = Tuple[Any, ...]

# FSDP x TP on ("pod", "data", "model"); "pod" is an outer data dim and a
# mesh without it skips it, so one table serves both meshes.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "embed": ("data",),  # FSDP: weights sharded along embed over data
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "qkv": ("model",),
    "kv_seq": ("model",),  # decode-time KV cache sequence sharding (SP)
    "act_seq": ("model",),  # inter-block activation sequence parallelism
    "seq": (),
    "layers": (),
    "state": (),
    "conv": (),
}


def make_rules(**overrides: Any) -> Rules:
    rules = dict(DEFAULT_RULES)
    for k, v in overrides.items():
        if v is None:
            rules[k] = ()
        elif isinstance(v, str):
            rules[k] = (v,)
        else:
            rules[k] = tuple(v)
    return rules


def _normalize(rule: Any) -> Tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` (or of anything whose
    ``shape`` is already that dict, as the reference's ``Mesh``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_to_pspec(axes: Sequence[Optional[str]], shape: Sequence[int], rules: Rules,
                     mesh) -> PSpec:
    """The spec of a tensor with logical ``axes`` and ``shape`` on ``mesh``."""
    sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        mesh_axes: Tuple[str, ...] = ()
        if name is not None:
            cand = [a for a in _normalize(rules.get(name, ())) if a in sizes and a not in used]
            # greedy prefix whose product divides the dim
            chosen = []
            prod = 1
            for a in cand:
                if dim % (prod * sizes[a]) == 0:
                    chosen.append(a)
                    prod *= sizes[a]
            mesh_axes = tuple(chosen)
            used.update(mesh_axes)
        if len(mesh_axes) == 0:
            entries.append(None)
        elif len(mesh_axes) == 1:
            entries.append(mesh_axes[0])
        else:
            entries.append(mesh_axes)
    return tuple(entries)


def param_pspecs(specs_tree, rules: Rules, mesh):
    """Tree of specs matching a tree of :class:`ParamSpec`."""
    return tree_map(lambda s: logical_to_pspec(s.axes, s.shape, rules, mesh), specs_tree)


def placements(pspec: PSpec, mesh) -> tuple:
    """DTensor placements of ``pspec`` on a ``DeviceMesh``: for each mesh
    dim, ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.  A tensor dim over several mesh dims is ``Shard(d)`` on
    each; DTensor splits it in mesh-dim order, so the entry must name them
    in that order (the reference's rules do: ``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(pspec):
        dims = [names.index(a) for a in _normalize(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} splits a dim against the mesh's order "
                             f"{names}: DTensor cannot place it")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on the mesh: its spec and the placements."""

    mesh: Any
    spec: PSpec
    placements: tuple

    def place(self, x: torch.Tensor):
        """``x`` (the whole tensor, the same on every rank) as a DTensor on
        the mesh, each rank keeping its shard: bit for bit ``x``'s values."""
        from torch.distributed.tensor import distribute_tensor

        x = x.to(self.mesh.device_type)
        return distribute_tensor(x, self.mesh, self.placements)


def sharding_of(axes, shape, rules: Rules, mesh) -> Sharding:
    spec = logical_to_pspec(axes, shape, rules, mesh)
    return Sharding(mesh, spec, placements(spec, mesh))


def param_shardings(specs_tree, rules: Rules, mesh):
    """Tree of :class:`Sharding` matching a tree of :class:`ParamSpec`."""
    return tree_map(lambda s: sharding_of(s.axes, s.shape, rules, mesh), specs_tree)


def distribute(tree, shardings):
    """Every leaf of ``tree`` placed by the matching :class:`Sharding`."""
    return tree_map(lambda x, sh: sh.place(x), tree, shardings)


# ---------------------------------------------------------------------------
# the ambient mesh and rules, for activation constraints in model code

_ctx = threading.local()


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[Rules] = None):
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules or DEFAULT_RULES) if mesh is not None else None
    try:
        if mesh is None:
            yield
        else:
            with _implicit_replication():
                yield
    finally:
        _ctx.state = prev


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, reentrant: the public context
    manager clears its process-wide flag on exit even inside an outer one
    (a block's recomputation re-enters the rules: ``layers.remat``), so the
    flag is restored to what it was."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    if not hasattr(disp, "_allow_implicit_replication"):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            yield
        return
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def current_mesh_rules():
    return getattr(_ctx, "state", None)


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not torch.is_tensor(x):  # no import on the plain path
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def with_logical_constraint(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` redistributed to the rules' placement of ``axes`` when a mesh
    is active and ``x`` is a DTensor on it; otherwise ``x``."""
    state = current_mesh_rules()
    if state is None or not is_dtensor(x):
        return x
    mesh, rules = state
    want = placements(logical_to_pspec(axes, x.shape, rules, mesh), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# ops that run on each rank's shard: the kernels take plain tensors, and an
# op whose rows are independent along the sharded dims needs no DTensor rule


def local_shard(x, want: tuple, grad: Optional[tuple] = None):
    """``x`` (a DTensor) redistributed to ``want``, as its local shard;
    ``grad`` the placements of that shard's gradient (default ``want``)."""
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return x.to_local(grad_placements=grad)


def local_shape_and_offset(shape, mesh, want: tuple) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of ``shape`` placed ``want`` on
    ``mesh``: its shape and where it starts, per dim.  DTensor's split,
    computed on the host (no tensor op, so it runs under fake tensors too):
    each ``Shard(d)`` in mesh-dim order cuts dim ``d`` into chunks of
    ``ceil(n / size)`` rows, the last ones shorter or empty."""
    from torch.distributed.tensor import Shard

    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(want):
        if isinstance(p, Shard):
            n, k = shape[p.dim], mesh.size(m)
            chunk = -(-n // k)
            start = min(coord[m] * chunk, n)
            shape[p.dim] = min(start + chunk, n) - start
            offset[p.dim] += start
    return tuple(shape), tuple(offset)


def global_offset(x, want: tuple) -> Tuple[int, ...]:
    """Where this rank's shard of ``x`` under ``want`` starts, per dim."""
    return local_shape_and_offset(x.shape, x.device_mesh, want)[1]


def from_local(out: torch.Tensor, mesh, want: tuple, shape) -> torch.Tensor:
    """Each rank's ``out`` as the DTensor of ``shape`` placed ``want``."""
    from torch.distributed.tensor import DTensor

    # contiguous, as the global stride it is given says (a backend may return
    # a transposed view)
    return DTensor.from_local(out.contiguous(), mesh, want, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _keeping(x, dims) -> tuple:
    """``x``'s placements with a ``Shard`` of a dim in ``dims`` kept and
    every other placement replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in x.placements)


def _moved(want: tuple, dims: Dict[int, int]) -> tuple:
    """``want`` with ``Shard(d)`` renamed ``Shard(dims[d])``."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) else p for p in want)


def _partial_where(want: tuple, dims) -> tuple:
    """Gradient placements of a tensor whole on the mesh dims where
    ``want`` shards one of ``dims``: each rank's part is a partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return tuple(Partial() if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in want)


def softmax_on_shards(fn, x, *, where=None, axis: int = -1):
    """``fn(x_local, where=..., axis=...)`` on every rank's shard of the
    DTensor ``x`` (and of the DTensor ``where``): the softmax axis is made
    whole (replicated), every other dim keeps its sharding, and the rows
    are independent, so each rank's rows are the whole tensor's.  A DTensor
    out, placed as the input."""
    ax = axis % x.ndim
    want = _keeping(x, set(range(x.ndim)) - {ax})
    wl = None if where is None else local_shard(where, want)
    return from_local(fn(local_shard(x, want), where=wl, axis=axis), x.device_mesh, want,
                      x.shape)


def attention_on_shards(fn, q, k, v, *, q_offset=0, kv_valid_len=None):
    """``fn(q, k, v, q_offset=, kv_valid_len=)`` on every rank's shard of the
    DTensors q, k and v: q ``[B, Tq, Hq, D]`` keeps a batch, q-row or head
    sharding, k / v ``[B, Tk, Hkv, D]`` follow its batch and head sharding
    (heads only where the KV heads divide as the query heads do, so each
    rank's GQA groups are whole) and are whole along Tk and D.  A rank's q
    rows start at its shard's row offset, which it adds to ``q_offset`` for
    the causal mask and the window; ``kv_valid_len`` ``[B]`` takes the
    rank's batch rows.  Where the q rows are sharded, a rank's K / V
    gradient covers its rows only: it is a partial sum over that mesh
    dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    rep = Replicate()
    hq, hkv = q.shape[2], k.shape[2]
    q_want, kv_want = [], []
    for m, p in enumerate(q.placements):
        n = mesh.size(m)
        heads_split = hkv % n == 0 and (hkv // n) * (hq // hkv) == hq // n
        if isinstance(p, Shard) and (p.dim == 0 or (p.dim == 2 and heads_split)):
            q_want.append(p)
            kv_want.append(p)
        elif isinstance(p, Shard) and p.dim == 1:
            q_want.append(p)
            kv_want.append(rep)
        else:
            q_want.append(rep)
            kv_want.append(rep)
    q_want, kv_want = tuple(q_want), tuple(kv_want)
    kv_grad = tuple(Partial() if isinstance(p, Shard) and p.dim == 1 else w
                    for p, w in zip(q_want, kv_want))

    off = global_offset(q, q_want)
    ql = local_shard(q, q_want)
    kl, vl = local_shard(k, kv_want, kv_grad), local_shard(v, kv_want, kv_grad)
    q_offset = replicated_value(q_offset)  # a decode cache's device len, replicated
    if off[1]:
        q_offset = q_offset + off[1]
    if kv_valid_len is not None:
        if is_dtensor(kv_valid_len):
            kv_valid_len = kv_valid_len.full_tensor()
        kv_valid_len = kv_valid_len[off[0]:off[0] + ql.shape[0]]
    out = fn(ql, kl, vl, q_offset=q_offset, kv_valid_len=kv_valid_len)
    shape = tuple(q.shape[:3]) + (v.shape[3],)
    return from_local(out, mesh, q_want, shape)


def whole_unless_divides(x, dim: int, parts: int):
    """``x`` with ``dim`` made whole on the mesh dims whose sharding would
    cut one of its ``parts`` equal pieces (the heads of a fused ``[..., H *
    D]`` projection: 8 KV heads' 1024 columns over a 16-way dim), so that
    splitting ``dim`` into ``(parts, -1)`` keeps every piece on one rank."""
    from torch.distributed.tensor import Replicate, Shard

    want, prod = [], 1
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            if parts % (prod * x.device_mesh.size(m)) == 0:
                prod *= x.device_mesh.size(m)
            else:
                p = Replicate()
        want.append(p)
    want = tuple(want)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


class KVRowsShardedError(NotImplementedError):
    """Attention over K / V split along their rows (a cache sharded by
    "kv_seq") on a route the split softmax does not serve: a kernel, whose
    one launch needs a whole row, or a faulty softmax, whose realization is
    drawn for a whole row."""


def kv_rows_split(k, q=None) -> Tuple[int, ...]:
    """The mesh dims of size > 1 that split the DTensor ``k`` ``[B, Tk,
    Hkv, D]`` along its rows (none for a plain tensor) and do not split
    ``q``'s rows: a cache sharded by "kv_seq" under a decode token.  Where
    the q rows are split too (sequence parallelism), each rank's rows need
    every K row, and :func:`attention_on_shards` makes K whole."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(k):
        return ()
    q_rows = set() if q is None or not is_dtensor(q) else {
        m for m, p in enumerate(q.placements) if isinstance(p, Shard) and p.dim == 1}
    return tuple(m for m, p in enumerate(k.placements)
                 if isinstance(p, Shard) and p.dim == 1 and k.device_mesh.size(m) > 1
                 and m not in q_rows)


class _AcrossRanks:
    """All-reduces over the mesh dims ``dims`` of ``mesh``: ``max`` and
    ``sum`` of a local partial, the same result on every rank of a group."""

    def __init__(self, mesh, dims):
        self.mesh, self.dims = mesh, tuple(dims)

    def _reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol

        for m in self.dims:
            t = funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op, (self.mesh, m)))
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, "max")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, "sum")


def replicated_value(x):
    """A replicated DTensor's value (a cache's device ``len`` / ``pos``) as
    a plain tensor; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def attention_rows_sharded(fn, q, k, v, *, q_offset=0, kv_valid_len=None):
    """``fn(q, k, v, q_offset=, kv_valid_len=, kv_offset=, across=)`` (the
    materialized :func:`~repro_torch.core.attention.attention`) on every
    rank's shard, with K / V split along their rows (Tk) over the mesh dims
    :func:`kv_rows_split` names, as the reference's XLA partitioner computes
    decode over a "kv_seq"-sharded cache: no rank gathers K or V.

    Each rank scores its own Tk slice (columns from ``kv_offset``, its
    slice's row offset) for every head of its batch rows (q is made whole
    along its heads and rows, a ``[B, Tq, Hq, D]`` gather of one token a row
    at decode), and ``across`` all-reduces over the split dims: the row max
    (MAX: STAR's int32 grid max, exact), the denominator (SUM: STAR's
    numerator sums or its histogram's integer counts, or the exact
    softmax's exponentials) and P.V (SUM).  Only the summation order
    differs from the unsharded route, so the results agree to float32
    rounding.  Returns ``[B, Tq, Hq, D]`` placed as q's batch, whole
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = k.device_mesh
    rep = Replicate()
    q_want, kv_want = [], []
    for p in k.placements:
        if isinstance(p, Shard) and p.dim == 1:
            q_want.append(rep)
            kv_want.append(p)
        elif isinstance(p, Shard) and p.dim == 0:
            q_want.append(p)
            kv_want.append(p)
        else:
            q_want.append(rep)
            kv_want.append(rep)
    q_want, kv_want = tuple(q_want), tuple(kv_want)
    ql, kl, vl = local_shard(q, q_want), local_shard(k, kv_want), local_shard(v, kv_want)
    off = global_offset(k, kv_want)
    if kv_valid_len is not None:
        if is_dtensor(kv_valid_len):
            kv_valid_len = kv_valid_len.full_tensor()
        kv_valid_len = kv_valid_len[off[0]:off[0] + ql.shape[0]]
    out = fn(ql, kl, vl, q_offset=replicated_value(q_offset), kv_valid_len=kv_valid_len,
             kv_offset=off[1], across=_AcrossRanks(mesh, kv_rows_split(k, q)))
    return from_local(out, mesh, q_want, tuple(q.shape[:3]) + (v.shape[3],))


def write_row_on_shards(cache, row, idx) -> None:
    """``cache[:, idx] = row`` in place, on the shards: ``cache`` ``[B, T,
    H, D]`` is a DTensor (its rows may be split over "kv_seq"), ``row``
    ``[B, 1, H, D]`` the step's fresh K or V row and ``idx`` a 0-dim index
    tensor (the cache's device ``len``).  The rank whose slice holds row
    ``idx`` writes it into its local shard; every other rank writes its old
    row back.  Nothing of the cache is gathered."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.attention import _as_long

    want = tuple(cache.placements)
    (lb, lt, lh, _), off = local_shape_and_offset(cache.shape, cache.device_mesh, want)
    if lt == 0:
        return
    local = cache.to_local()
    if is_dtensor(row):
        row_want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in want)
        rl = local_shard(row, row_want)
    else:
        rl = row[off[0]:off[0] + lb, :, off[2]:off[2] + lh]
    li = _as_long(replicated_value(idx), local.device).reshape(1) - off[1]
    hit = (li >= 0) & (li < lt)
    safe = torch.clamp(li, 0, lt - 1)
    old = local.index_select(1, safe)
    local.index_copy_(1, safe, torch.where(hit, rl.to(local.dtype), old))


def zeros_placed(shape, axes, dtype, device):
    """Zeros of ``shape``: under a mesh, a DTensor placed by the rules'
    reading of ``axes`` (each rank allocates its shard only), else a plain
    tensor."""
    state = current_mesh_rules()
    if state is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    mesh, rules = state
    want = sharding_of(axes, shape, rules, mesh).placements
    local = torch.zeros(local_shape_and_offset(shape, mesh, want)[0], dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, want, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def copy_rows_on_shards(dst, src, dim: Optional[int] = None) -> None:
    """``dst.narrow(dim, 0, n).copy_(src)`` (``n`` = ``src``'s rows along
    ``dim``; ``dim=None``: ``dst.copy_(src)``, the same shape) in place, on
    the shards of the DTensor ``dst``: ``src`` is placed as ``dst`` but
    whole along ``dim``, and each rank copies the rows its slice of ``dst``
    holds."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(dst.placements)
    lshape, off = local_shape_and_offset(dst.shape, dst.device_mesh, want)
    if is_dtensor(src):
        sl = local_shard(src, tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                                    for p in want))
    else:
        sl = src
        for d in range(src.ndim):
            if d != dim:
                sl = sl.narrow(d, off[d], lshape[d])
    if dim is None:
        dst.to_local().copy_(sl)
        return
    lo = off[dim]
    n = min(lo + lshape[dim], src.shape[dim]) - lo
    if n > 0:
        dst.to_local().narrow(dim, 0, n).copy_(sl.narrow(dim, lo, n))


def rows_on_shards(fn, x, dim: int, rows: int):
    """``fn(x_local)`` with ``x``'s ``dim`` made whole and every other
    sharding kept: an op along the rows (a pad, a roll) that some torch
    versions' DTensor rules refuse.  ``rows`` is the output's size along
    ``dim``."""
    want = _keeping(x, set(range(x.ndim)) - {dim})
    out = fn(local_shard(x, want))
    shape = list(x.shape)
    shape[dim] = rows
    return from_local(out, x.device_mesh, want, shape)


def take_last_on_shards(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]`` on every rank's shard: ``x``
    ``[..., V]`` keeps its leading dims' sharding and is made whole along
    V, ``idx`` (a DTensor or a plain tensor of ``x``'s leading shape) is
    placed as those dims.  The gradient scatters into each rank's own shard
    only."""
    want = _keeping(x, set(range(x.ndim - 1)))
    xl = local_shard(x, want)
    if is_dtensor(idx):
        il = local_shard(idx, want)
    else:
        shape, off = local_shape_and_offset(idx.shape, x.device_mesh, want)
        il = idx
        for d in range(idx.ndim):
            il = il.narrow(d, off[d], shape[d])
    out = xl.gather(-1, il.long()[..., None])[..., 0]
    return from_local(out, x.device_mesh, want, tuple(x.shape[:-1]))


def merge_heads_on_shards(x):
    """``x [B, T, H, D] -> [B, T, H * D]`` on every rank's shard: the batch,
    row and head shardings are kept (a head shard is a column shard of the
    merged dim), D is made whole."""
    want = _keeping(x, (0, 1, 2))
    xl = local_shard(x, want)
    out = xl.reshape(xl.shape[0], xl.shape[1], -1)
    return from_local(out, x.device_mesh, want, tuple(x.shape[:2]) + (x.shape[2] * x.shape[3],))


def matmul_plan(x_placements, w_placements, ndim: int):
    """How :func:`matmul_on_shards` places ``x [..., K]`` (``ndim`` dims)
    and ``w [K, N]`` on each mesh dim: ``(x_want, w_want, x_grad, w_grad,
    out)`` placements.  Per mesh dim, in this order:

    * ``x`` sharded along a leading dim (the batch; the rows under sequence
      parallelism): kept, ``w`` made whole; each rank's ``w`` gradient
      covers its own rows of ``x`` only, a partial sum (``Partial``);
    * ``w`` sharded along N (column parallel): kept, ``x`` made whole; the
      output is sharded along N, and ``x``'s gradient is a partial sum;
    * ``w`` sharded along K and ``x`` whole or sharded along K (row
      parallel): ``x`` cut as ``w``; each rank's output is a partial sum
      (``Partial``, all-reduced at once);
    * otherwise both whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rep = Replicate()
    plan = ([], [], [], [], [])
    for xp, wp in zip(x_placements, w_placements):
        if isinstance(xp, Shard) and xp.dim < ndim - 1:
            row = (xp, rep, xp, Partial(), xp)
        elif isinstance(wp, Shard) and wp.dim == 1:
            row = (rep, wp, Partial(), wp, Shard(ndim - 1))
        elif isinstance(wp, Shard) and wp.dim == 0 and (
                isinstance(xp, Replicate) or (isinstance(xp, Shard) and xp.dim == ndim - 1)):
            k = Shard(ndim - 1)  # a whole x is cut locally
            row = (k, wp, k, wp, Partial())
        else:
            row = (rep, rep, rep, rep, rep)
        for acc, p in zip(plan, row):
            acc.append(p)
    return tuple(tuple(p) for p in plan)


def matmul_on_shards(x, w):
    """``x [..., K] @ w [K, N]`` on every rank's shard, placed by
    :func:`matmul_plan`.  DTensor's own rule flattens the leading dims into
    one, which a sharded second dim (sequence parallelism) refuses, and may
    leave an activation a partial sum whose gradient some torch versions
    cannot place back; here a partial output is all-reduced at once, so
    every output is sharded or whole.  The weight's gradient is reduced into
    the weight's own placement."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = x.device_mesh
    rep = Replicate()
    w_pl = tuple(w.placements) if is_dtensor(w) else (rep,) * mesh.ndim
    x_want, w_want, x_grad, w_grad, out = matmul_plan(x.placements, w_pl, x.ndim)
    xl = local_shard(x, x_want, x_grad)
    wl = local_shard(w, w_want, w_grad) if is_dtensor(w) else w
    y = from_local(xl @ wl, mesh, out, tuple(x.shape[:-1]) + (w.shape[1],))
    if any(isinstance(p, Partial) for p in out):
        y = y.redistribute(mesh, tuple(rep if isinstance(p, Partial) else p for p in out))
    return y


def ssd_scan_on_shards(fn, xdt, a, bmat, cmat):
    """``fn(xdt, a, bmat, cmat) -> (y, state)`` (the SSD chunk scan) on every
    rank's shard: ``xdt`` ``[B, T, H, P]`` and ``a`` ``[B, T, H]`` keep a
    batch or head sharding, B / C ``[B, T, N]`` (one group, shared by the
    heads) follow the batch only, and T is whole.  A rank's B / C gradient
    covers its heads only: a partial sum over a heads-sharded mesh dim."""
    from torch.distributed.tensor import Partial, Shard

    mesh = xdt.device_mesh
    want = _keeping(xdt, (0, 2))
    bc_want = _keeping(xdt, (0,))
    bc_grad = tuple(Partial() if isinstance(p, Shard) and p.dim == 2 else w
                    for p, w in zip(want, bc_want))
    xl = local_shard(xdt, want)
    al = local_shard(a, want)
    bl = local_shard(bmat, bc_want, bc_grad)
    cl = local_shard(cmat, bc_want, bc_grad)
    y, state = fn(xl, al, bl, cl)
    b, _, h, p = xdt.shape
    return (from_local(y, mesh, want, xdt.shape),
            from_local(state, mesh, _moved(want, {0: 0, 2: 1}), (b, h, bmat.shape[-1], p)))


def scan_on_shards(fn, x, a, h0):
    """``fn(x, a, h0) -> (h_all, h_last)`` (a linear recurrence along T, per
    batch row and channel) on every rank's shard: ``x`` / ``a`` ``[B, T,
    W]`` keep a batch or channel sharding, T is whole, ``h0`` ``[B, W]``
    follows them."""
    want = _keeping(x, (0, 2))
    h0l = None if h0 is None else local_shard(h0, _moved(want, {0: 0, 2: 1}))
    hs, _ = fn(local_shard(x, want), local_shard(a, want), h0l)
    hs = from_local(hs, x.device_mesh, want, x.shape)
    return hs, hs[:, -1]


def embed_on_shards(table, tokens):
    """``table[tokens]`` on every rank's shard: the tokens keep their
    sharding, the table ``[V, D]`` is made whole, and the table's gradient
    is a partial sum over the tokens' mesh dims."""
    mesh = tokens.device_mesh
    want = tuple(tokens.placements)
    t = local_shard(table, _keeping(table, ()), _partial_where(want, range(tokens.ndim)))
    rows = t[tokens.to_local().long()]
    return from_local(rows, mesh, want, tuple(tokens.shape) + (table.shape[1],))


def conv_on_shards(fn, kernel, x):
    """``fn(kernel, x) -> y`` (the causal depthwise conv along T, no state)
    on every rank's shard: ``x`` ``[B, T, C]`` keeps its batch sharding, T
    and the channels are whole, and so is the kernel ``[W, C]``, whose
    gradient is a partial sum over the batch's mesh dims."""
    mesh = x.device_mesh
    want = _keeping(x, (0,))
    w = local_shard(kernel, _keeping(kernel, ()), _partial_where(want, (0,)))
    return from_local(fn(w, local_shard(x, want)), mesh, want, x.shape)


def bytes_per_device(specs_tree, rules: Rules, mesh) -> int:
    """Parameter bytes resident per device under the rules (napkin math)."""
    from repro_torch.models.param import named_leaves

    sizes = mesh_shape(mesh)
    total = 0
    for _, s in named_leaves(specs_tree):
        pspec = logical_to_pspec(s.axes, s.shape, rules, mesh)
        shards = 1
        for entry in pspec:
            for a in _normalize(entry):
                shards *= sizes[a]
        total += int(np.prod(s.shape)) * _itemsize(s.dtype) // max(shards, 1)
    return total


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()
