"""Device meshes over the process group (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims over the
process group the caller has already initialized (``init_process_group``,
or ``torchrun``): NCCL over the cards, gloo when the CPU is asked for.
Functions, not module constants, so importing this module touches no
device and no process group.

Single pod: 16 x 16 = 256 devices ``("data", "model")``.  Multi-pod: 2 x 16
x 16 = 512 ``("pod", "data", "model")``, "pod" the slowest-varying dim.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ops.platform import Device, resolve_device


class MeshShapeError(ValueError):
    """A mesh whose device count is not the process group's world size."""


def backend_for(device: Device = None) -> str:
    """The process group's backend for ``device``: ``"nccl"`` on the card,
    ``"gloo"`` on the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def make_mesh(shape, axes, device: Device = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    initialized process group, on the card unless ``device`` asks for the
    CPU.  The group's backend must be the device's (NCCL for the card, gloo
    for the CPU): a mesh is never built over another backend instead."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or torchrun)")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise MeshShapeError(f"mesh {shape} {axes} needs {int(np.prod(shape))} ranks, "
                             f"the process group has {world}")
    dev = resolve_device(device)
    want = backend_for(dev)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"a mesh on {dev.type} needs the {want} backend, the process "
                           f"group runs {have}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: Device = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} devices for the production mesh, found {have}")
    return make_mesh(shape, axes, device)


def init_process_group(device: Device = None, *, rank: int = 0, world_size: int = 1,
                       store=None, init_method=None, timeout_s: float = 120.0) -> None:
    """Initialize the default process group for ``device``'s backend; a
    given ``store`` (a ``FileStore`` or ``HashStore``) is the rendezvous.
    On the card each rank takes card ``rank % device_count``."""
    import datetime

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {"store": store} if store is not None else {"init_method": init_method}
    dist.init_process_group(backend_for(dev), rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
