"""Roofline terms of a dry-run cell, counted on the ops the port issues
(port of ``repro.launch.roofline``).

Three terms per (arch, shape, mesh), all in seconds, with the constants of
one NVIDIA H100 SXM card (NVIDIA H100 80GB HBM3, 700 W): bf16 dense tensor
cores at 989e12 FLOP/s, HBM3 at 3.35e12 B/s and NVLink 4 at 450e9 B/s each
way (the card's data sheet)::

  compute    = FLOPs_per_dev / PEAK_FLOPS
  memory     = bytes_per_dev / HBM_BW
  collective = collective_bytes_per_dev / LINK_BW

The reference reads FLOPs and bytes from XLA's cost analysis and parses the
collectives out of the partitioned HLO.  The port runs the step eagerly on
fake tensors, so it counts what each rank actually issues
(:class:`CostCounter`, a dispatch mode that sees every op on a rank's local
shards once DTensor has lowered it):

* FLOPs: ``torch.utils.flop_counter``'s formulas (the matmul, convolution
  and attention ops; the elementwise ops count none, as in
  ``FlopCounterMode``).
* bytes: the input and output bytes of every aten op that is not a view
  or a bare allocation (``empty``), each op on its own, as XLA's "bytes
  accessed" sums them per instruction.
  That is an eager port's real traffic: no op is fused.
* collective bytes: the operand bytes of every collective a rank issues
  (``_c10d_functional`` and ``c10d``: DTensor's redistributes and the
  port's own ``all_reduce`` calls), by the reference's five names.
* peak live bytes: the arguments' local shards plus the most bytes of
  storage that the step held alive at once.

A stated simplification, not a measurement: the production mesh's 16-way
"model" dim spans two 8-card hosts, so part of its traffic would cross
InfiniBand, not NVLink; the collective term still divides every byte by
NVLink's rate.  Nothing here is a time taken on the card.
"""

from __future__ import annotations

import sys
import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM (NVIDIA H100 80GB HBM3, 700 W), from its data sheet
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s a card
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s, NVLink 4, each way

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# the collective op packets, by (namespace, name), and the reference's name
_COLLECTIVES = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced_"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional", "broadcast"): "collective-permute",
    ("_c10d_functional", "broadcast_"): "collective-permute",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "broadcast_"): "collective-permute",
    ("c10d", "send"): "collective-permute",
}


# ops that only allocate: they read and write no bytes
_ALLOCATIONS = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                          "new_empty_strided"})


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_of(func) -> Any:
    packet = func._overloadpacket
    return _COLLECTIVES.get((func.namespace, packet.__name__))


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collectives and live storage of the ops run
    under it, on local tensors only: an op on a DTensor (or on a pending
    collective's result) is handed back to the subclass, which lowers it to
    local ops and collectives that come here.  :attr:`calls` keeps each
    collective's ``(name, operand shapes, dtypes, bytes)``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
        self.count: Dict[str, int] = {op: 0 for op in COLLECTIVE_OPS}
        self.calls: list = []
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}  # id(storage) -> bytes counted (0: external)

    # -- storage liveness --------------------------------------------------

    def track_external(self, tensors: Iterable[torch.Tensor]) -> int:
        """Mark the storages of ``tensors`` (the step's arguments) as known,
        so an op that writes them in place or views them adds nothing to
        the live count.  Returns their bytes (each storage once)."""
        total = 0
        for t in tensors:
            t = _local(t)
            st = t.untyped_storage()
            if id(st) not in self._storages:
                self._storages[id(st)] = 0
                total += st.nbytes()
        return total

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- dispatch -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(_is_wrapper(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out  # DTensor inferring a global shape: no rank runs it
        name = _collective_of(func)
        if name is not None:
            ins = _tensors((args, kwargs))
            n = sum(_nbytes(t) for t in ins)
            self.by_op[name] += n
            self.count[name] += 1
            self.calls.append((name, [tuple(t.shape) for t in ins],
                               [str(t.dtype) for t in ins], n))
        elif func.namespace == "aten":
            packet = func._overloadpacket
            if packet in self._flop_registry:
                self.flops += int(self._flop_registry[packet](*args, **kwargs, out_val=out))
            if not func.is_view and packet.__name__ not in _ALLOCATIONS:
                self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out

    def collectives(self) -> Dict[str, Any]:
        """Collective operand bytes a rank issued, ``{"total": int, "by_op":
        {op: bytes}, "count": {op: n}}``: the counterpart of the reference's
        ``collective_bytes``, which parses them out of the partitioned HLO."""
        return {
            "total": int(sum(self.by_op.values())),
            "by_op": {k: int(v) for k, v in self.by_op.items() if v},
            "count": {k: int(v) for k, v in self.count.items() if v},
        }


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is running: it infers an op's
    output shape by running the op on fake tensors of the *global* shapes,
    work that no rank does."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _is_wrapper(t) -> bool:
    """A tensor subclass that lowers its ops to local ones: DTensor, and
    the pending result of a functional collective."""
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor) or t.__name__ == "AsyncCollectiveTensor"


def _local(t: torch.Tensor) -> torch.Tensor:
    from repro_torch.distributed.sharding import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def model_flops(n_params: int, n_active_params: int, tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for an inference forward (N = active params)."""
    n = n_active_params or n_params
    return (6.0 if kind == "train" else 2.0) * n * tokens


def roofline_terms(
    *,
    flops_per_dev: float,
    bytes_per_dev: float,
    coll_bytes_per_dev: float,
) -> Dict[str, float]:
    t_c = flops_per_dev / PEAK_FLOPS
    t_m = bytes_per_dev / HBM_BW
    t_x = coll_bytes_per_dev / LINK_BW
    dominant = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    bound = max(t_c, t_m, t_x)
    return {
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "dominant": dominant,
        "roofline_fraction": (t_c / bound) if bound > 0 else 0.0,
    }


def active_param_count(cfg, pspecs) -> int:
    """Active parameters a token (MoE: only the top_k experts count)."""
    from repro_torch.models.param import count_params

    total = count_params(pspecs)
    if cfg.family != "moe" or cfg.num_experts == 0:
        return total
    # expert weights: [E, d, f] x3 a layer
    expert_per_layer = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff
    expert_total = cfg.num_layers * expert_per_layer
    active_expert = expert_total * cfg.top_k / cfg.num_experts
    return int(total - expert_total + active_expert)
