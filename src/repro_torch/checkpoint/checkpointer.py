"""Atomic checkpoints with rotation and auto-resume (port of
``repro.checkpoint.checkpointer``), in the reference's on-disk layout, so a
checkpoint written by either package restores in the other.

Layout: ``<dir>/step_<n:08d>/`` holding one ``.npy`` per leaf, named by
its key path joined with ``__`` (``params__blocks__attn__wq.npy``), and
``index.json`` (``{"step": n, "leaves": [{"name", "shape", "dtype"}]}``,
leaves in sorted key order).  A save writes ``step_<n:08d>.tmp`` and then
renames it, so a crashed writer never leaves a broken newest checkpoint.

bfloat16 leaves: numpy has no bfloat16, and the reference writes one
through ``ml_dtypes``, which numpy saves as 2-byte void items (descr
``'<V2'``) under the index's dtype ``"bfloat16"``.  The port needs no
``ml_dtypes``: it writes the same header and the tensor's 2-byte payload
(byte for byte the reference's file), and reads a leaf whose index dtype is
``"bfloat16"`` by viewing the loaded bytes as int16 and then as
``torch.bfloat16``.

Sharded states: a DTensor leaf is gathered whole (``full_tensor()``, which
every rank calls, in the same leaf order) and rank 0 writes the same files
as for an unsharded state; every rank then waits at a barrier.  Where a
process group is up, only rank 0 writes or rotates.  ``restore(...,
shardings=...)`` places each leaf on any mesh, so a checkpoint saved on one
mesh restores on another (``distributed.elastic``) or on one device.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.param import named_leaves, unflatten
from repro_torch.ops.platform import Device, resolve_device

Params = Dict[str, Any]
_SEP = "__"


def _save_leaf(path: str, leaf: torch.Tensor) -> Tuple[Tuple[int, ...], str]:
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
            f.write(t.view(torch.int16).numpy().tobytes())
        return tuple(t.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return arr.shape, str(arr.dtype)


def _load_leaf(path: str, dtype: str, device: torch.device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not _distributed() or dist.get_rank() == 0


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def save(ckpt_dir: str, step: int, state: Params) -> str:
    """Atomic save of a tree of tensors (or DTensors: every rank calls it);
    returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    writer = _writer()
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    index = {"step": step, "leaves": []}
    for path, leaf in named_leaves(state):
        leaf = _whole(leaf)
        if not writer:
            continue
        name = _SEP.join(path)
        shape, dtype = _save_leaf(os.path.join(tmp, name + ".npy"), leaf)
        index["leaves"].append({"name": name, "shape": list(shape), "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if _distributed():
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "index.json"))
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Params, step: Optional[int] = None,
            device: Device = None, shardings: Optional[Params] = None) -> Tuple[Params, int]:
    """``(tree, step)``: the checkpoint at ``step`` (default the newest)
    with ``template``'s structure (its leaves are read for their paths
    only), each leaf in its saved dtype on ``device`` (default the card).
    Given ``shardings`` (``distributed.sharding.param_shardings`` of the
    same tree), each leaf is placed by its sharding instead, on the mesh's
    device: every rank calls it."""
    dev = torch.device("cpu") if shardings is not None else resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "index.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    paths = [path for path, _ in named_leaves(template)]
    places = None if shardings is None else [sh for _, sh in named_leaves(shardings)]
    leaves = []
    for i, path in enumerate(paths):
        name = _SEP.join(path)
        leaf = _load_leaf(os.path.join(final, name + ".npy"), dtypes[name], dev)
        leaves.append(leaf if places is None else places[i].place(leaf))
    return unflatten(paths, leaves), step


def rotate(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the ``keep`` newest checkpoints (rank 0 alone where a
    process group is up)."""
    if not _writer() or not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
