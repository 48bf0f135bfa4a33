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
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _ctx.state = prev


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


def global_offset(x, want: tuple) -> Tuple[int, ...]:
    """Where this rank's shard of ``x`` under ``want`` starts, per dim."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(x.shape, x.device_mesh, want)[1])


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
    if off[1]:
        q_offset = q_offset + off[1]
    if kv_valid_len is not None:
        if is_dtensor(kv_valid_len):
            kv_valid_len = kv_valid_len.full_tensor()
        kv_valid_len = kv_valid_len[off[0]:off[0] + ql.shape[0]]
    out = fn(ql, kl, vl, q_offset=q_offset, kv_valid_len=kv_valid_len)
    shape = tuple(q.shape[:3]) + (v.shape[3],)
    return from_local(out, mesh, q_want, shape)


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
