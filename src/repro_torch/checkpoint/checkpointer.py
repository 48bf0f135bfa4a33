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
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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


def save(ckpt_dir: str, step: int, state: Params) -> str:
    """Atomic save of a tree of tensors; returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = {"step": step, "leaves": []}
    for path, leaf in named_leaves(state):
        name = _SEP.join(path)
        shape, dtype = _save_leaf(os.path.join(tmp, name + ".npy"), leaf)
        index["leaves"].append({"name": name, "shape": list(shape), "dtype": dtype})
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
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
            device: Device = None) -> Tuple[Params, int]:
    """``(tree, step)``: the checkpoint at ``step`` (default the newest)
    with ``template``'s structure (its leaves are read for their paths
    only), each leaf in its saved dtype on ``device`` (default the card)."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "index.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    paths = [path for path, _ in named_leaves(template)]
    leaves = []
    for path in paths:
        name = _SEP.join(path)
        leaves.append(_load_leaf(os.path.join(final, name + ".npy"), dtypes[name], dev))
    return unflatten(paths, leaves), step


def rotate(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the ``keep`` newest checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
