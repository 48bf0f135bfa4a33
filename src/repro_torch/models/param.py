"""Parameters: declared shapes + init rules, realized as nested dicts of
tensors with the per-layer blocks stacked on a leading ``[L]`` axis — the
same tree the JAX reference builds, so a reference pytree converts leaf by
leaf (:func:`from_reference`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.ops.platform import Device, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A parameter declaration: shape, logical axes, dtype and initializer.
    The axes name each dim for the sharding rules
    (``distributed.sharding``); ``None`` is a dim never sharded."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed | small
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts (and parallel trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def layer(tree, i: int):
    """Layer ``i`` of a tree of stacked ``[L, ...]`` leaves."""
    return tree_map(lambda x: x[i], tree)


def stack_specs(block_spec, n: int):
    """Prepend a ``"layers"`` axis ``[n]`` to every leaf of a block spec tree."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype,
                                        s.init, s.scale), block_spec)


def axes_tree(specs):
    """The logical-axes tree (same structure), for the sharding rules."""
    return tree_map(lambda s: s.axes, specs)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def named_leaves(tree):
    """``[(path, leaf)]`` of nested dicts in sorted key order (the order of
    ``jax.tree.leaves`` on the same dicts), each path the tuple of keys."""
    return [(tuple(path.split("/")[1:]), leaf) for path, leaf in _leaves(tree)]


def unflatten(paths, leaves):
    """Nested dicts from :func:`named_leaves`' paths and a leaf for each."""
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _init_one(spec: ParamSpec, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """The reference's init rules (``param._init_one``), drawn from ``gen``."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) == 1 else int(np.prod(spec.shape[:-1]))
        std = spec.scale / math.sqrt(max(fan_in, 1))
    elif spec.init == "embed":
        std = spec.scale * 0.02
    elif spec.init == "normal":
        std = spec.scale
    elif spec.init == "small":
        std = spec.scale * 1e-2
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    out = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return out.mul_(std).to(spec.dtype)


def materialize(specs, seed: int = 0, device: Device = None) -> Params:
    """Draw every leaf of a spec tree, in the tree's order, from one seeded
    ``torch.Generator`` on ``device``.  These are not the JAX reference's
    numbers; use :func:`from_reference` for those."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda s: _init_one(s, gen, dev), specs)


def from_reference(np_params, cfg, device: Device = None) -> Params:
    """The JAX reference's parameter pytree, given as nested dicts of numpy
    arrays (stacked ``[L, ...]`` blocks), as the port's parameters on
    ``device`` in ``cfg.param_dtype``: every leaf of the tree, a VLM's
    ``patch_proj`` among them, under the same names."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype),
        np_params,
    )


# the leaves the layers read only through ``.to(compute_dtype)``: the
# attention and MLP projections (and biases), the MoE router and experts, the
# unembed kernel, a VLM's ``patch_proj`` and an enc-dec model's
# ``frontend_proj`` kernels, the embed table (gather-then-cast equals
# cast-then-gather, ``layers.embed``), Mamba2's in / out projections, the
# conv kernels and an RG-LRU block's ``wx`` / ``wgate`` / ``wout``.  Norm
# scales and biases, ``A_log``, ``D``, ``dt_bias`` and ``out_norm`` are read
# through ``.float()`` and stay.
CAST_ONCE = frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv", "wi", "wg", "router", "kernel", "table",
    "in_proj", "out_proj", "wx", "wgate", "wout",
})
# An RG-LRU block (the dict holding ``lam``) reads its gate weights ``wa``
# and ``wi`` and its ``lam`` in float32: its ``wi`` shares the MLP's name
# but not its dtype, so the rule goes by the leaf's place, not its name.
RGLRU_FLOAT32 = frozenset({"wa", "wi", "lam"})


def casts_once(name: str, siblings) -> bool:
    """Whether ``compute_params`` casts the leaf ``name`` of a dict holding
    the keys ``siblings``: its place, not its name alone, decides."""
    if "lam" in siblings and name in RGLRU_FLOAT32:
        return False
    return name in CAST_ONCE


def compute_params(params: Params, cfg) -> Params:
    """The tree the engines compute with: every leaf that
    :func:`casts_once` cast to ``cfg.compute_dtype`` once, every other leaf
    the same tensor.  A cast depends only on the weight, so the layers' own
    ``.to(compute_dtype)`` then finds the type already right and copies
    nothing, and the results are bit for bit those of casting at every use.
    Idempotent and free on a tree already cast (``.to`` returns the same
    tensor); where the compute dtype is the parameter dtype no leaf is
    copied."""
    dtype = getattr(torch, cfg.compute_dtype)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(dtype) if casts_once(k, tree) else v)
                for k, v in tree.items()}

    return cast(params)


def count_params(specs) -> int:
    return int(sum(int(np.prod(s.shape)) for _, s in _leaves(specs)))
