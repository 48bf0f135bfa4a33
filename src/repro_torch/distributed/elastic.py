"""Elastic scaling: re-mesh planning and checkpoint resharding (port of
``repro.distributed.elastic``).

Checkpoints hold whole tensors, not shards, so elasticity is:
  1. a new mesh for the ranks that are left (``plan_mesh``),
  2. shardings from the same logical rules on it (``reshard_plan``),
  3. ``checkpointer.restore(..., shardings=...)``.

``plan_mesh`` keeps the model dim as large as it can (the TP degree is set
by the model's size, not the fleet's) and gives the rest to data.
"""

from __future__ import annotations

from repro_torch.distributed.sharding import Rules, param_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.ops.platform import Device


def plan_dims(n_devices: int, model_parallel: int):
    """``(data, model)``: the model dim halved until it divides."""
    mp = model_parallel
    while mp > 1 and n_devices % mp != 0:
        mp //= 2
    return n_devices // mp, mp


def plan_mesh(n_devices: int, *, model_parallel: int, device: Device = None):
    """The largest feasible ``("data", "model")`` mesh over ``n_devices``
    ranks: the process group's world size, which the mesh must cover."""
    return make_mesh(plan_dims(n_devices, model_parallel), ("data", "model"), device)


def reshard_plan(specs_tree, rules: Rules, new_mesh):
    """Shardings for ``restore()`` on the new mesh: the same logical rules."""
    return param_shardings(specs_tree, rules, new_mesh)
