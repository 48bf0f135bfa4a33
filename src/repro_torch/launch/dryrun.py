"""Dry-run of one (arch x shape) cell on the production mesh, on fake tensors
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 TPU chips and
reads XLA's cost and memory analyses.  The port builds the same mesh over a
*fake* process group (world size 256 or 512, this process rank 0:
``torch.testing._internal.distributed.fake_pg``), places the cell's
parameters, train state, cache and inputs as DTensors of fake tensors by
the logical rules (``FakeTensorMode``: shapes and dtypes, no storage), and
runs the cell's step eagerly at full width and full depth under
``use_mesh_rules`` — ``make_train_step``, ``model.prefill`` or
``model.decode_step``.  A collective on the fake group returns at once, so
one process traces what rank 0 of the real mesh would run, and
:class:`~repro_torch.launch.roofline.CostCounter` counts the FLOPs, bytes,
collectives and live storage of rank 0's local ops.

Every layer runs, so the counts are full-depth: the reference's depth
probes (compile one and two layers, extrapolate) have no counterpart, a
record says ``"probes": "full_depth"``, and ``--no-probes`` changes
nothing.  ``compile_s`` is the trace's seconds.

Memory budget: the reference spreads FSDP over "pod" too when a model's
parameters and AdamW state (10 bytes a parameter over 256 chips) pass 13 GB
of a 16 GB TPU v5e chip.  The port keeps that share of the card (13 / 16 of
80 GB: 65e9 bytes).  A comparison with the reference's plan passes the
reference's rules through ``--rules``.

  python -m repro_torch.launch.dryrun --arch granite_8b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single --out build/dryrun
  python -m repro_torch.launch.report build/dryrun

Runs on the card's device type (``cuda``) unless ``--device cpu``; nothing
is allocated on either.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

HBM_PER_CHIP = 80e9  # NVIDIA H100 80GB HBM3
# the reference's budget share: 13 GB of a 16 GB chip
BUDGET_BYTES = HBM_PER_CHIP * 13 / 16
CELL_TIMEOUT_S = 2400
DEFAULT_OUT = os.path.join("build", "dryrun")
SUMMARY_KEYS = (
    "arch", "shape", "mesh", "chips", "flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
    "t_compute_s", "t_memory_s", "t_collective_s", "dominant", "peak_bytes_per_dev",
    "useful_flops_ratio", "compile_s",
)


def fake_mesh(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process group
    of that many ranks, this process rank 0: its collectives return at
    once."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def production_mesh(mesh_kind: str, device: str = "cuda"):
    """The production mesh, ``(16, 16)`` ``("data", "model")`` or ``(2, 16,
    16)`` with "pod", over a fake process group."""
    if mesh_kind == "multi":
        return fake_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return fake_mesh((16, 16), ("data", "model"), device)


def _fake_placed(x, sharding, device):
    """A fake DTensor of ``x``'s global shape and dtype, placed by
    ``sharding``; its local shard is a fake tensor on ``device``."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import _contiguous_stride, local_shape_and_offset

    local_shape = local_shape_and_offset(x.shape, sharding.mesh, sharding.placements)[0]
    local = torch.zeros(local_shape, dtype=x.dtype, device=device)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=x.shape, stride=_contiguous_stride(x.shape))


def trace_cell(cfg, shape, mesh, rules, device: str = "cuda", microbatches: int = 1,
               moments_dtype: str = "float32") -> Dict[str, Any]:
    """Run the cell's step once on fake DTensors placed on ``mesh`` by
    ``rules``, under ``use_mesh_rules`` and a
    :class:`~repro_torch.launch.roofline.CostCounter`: the train step (with
    its AdamW update), ``prefill`` or ``decode_step`` (no grad), at the
    config's full width and depth.  Returns ``{"step", "counter",
    "argument_size_in_bytes", "output_size_in_bytes", "trace_s",
    "cache_all_gathers"}`` (the last for a decode step, else None)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import ops
    from repro_torch.distributed.sharding import param_shardings, sharding_of, use_mesh_rules
    from repro_torch.launch.roofline import CostCounter
    from repro_torch.launch.specs import cache_spec, input_specs
    from repro_torch.models.param import named_leaves, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import state_specs
    from repro_torch.train.step import TrainConfig, make_train_step

    model = build_model(cfg)
    pspecs = model.param_specs()
    kind, inputs = input_specs(cfg, shape)
    dev = torch.device(device)

    def placed(tree, specs):
        return tree_map(lambda x, sh: _fake_placed(x, sh, dev), tree,
                        param_shardings(specs, rules, mesh))

    def batch_placed(tree):
        def one(x):
            axes = ("batch",) + (None,) * (x.ndim - 1)
            return _fake_placed(x, sharding_of(axes, x.shape, rules, mesh), dev)
        return tree_map(one, tree)

    counter = CostCounter()
    # no kernel runs on fake tensors: the SSD scan takes its plain route, the
    # reference's own (its Mamba2 mixer calls the chunk scan directly)
    with FakeTensorMode(allow_non_fake_inputs=True), use_mesh_rules(mesh, rules), \
            ops.use(ssd_scan="reference"):
        if kind == "train":
            tc = TrainConfig(microbatches=microbatches,
                             adamw=AdamWConfig(moments_dtype=moments_dtype))
            args = (placed(inputs["state"], state_specs(pspecs, tc.adamw)),
                    batch_placed(inputs["batch"]))
            step = make_train_step(model, tc)
            run = lambda: step(*args)  # noqa: E731
        elif kind == "prefill":
            max_len = inputs.pop("_max_len")
            front = {k: batch_placed(v) for k, v in inputs.items()
                     if k not in ("params", "tokens")}
            params, toks = placed(inputs["params"], pspecs), batch_placed(inputs["tokens"])
            run = lambda: model.prefill(params, toks, max_len, **front)  # noqa: E731
            args = (params, toks) + tuple(front.values())
        else:
            cspecs = cache_spec(model, cfg, shape)
            args = (placed(inputs["params"], pspecs), placed(inputs["cache"], cspecs),
                    batch_placed(inputs["tokens"]))
            run = lambda: model.decode_step(*args)  # noqa: E731
        arg_bytes = counter.track_external(leaf for _, leaf in named_leaves(
            {str(i): a for i, a in enumerate(args)}))
        t0 = time.time()
        with counter, torch.no_grad() if kind != "train" else contextlib.nullcontext():
            out = run()
        trace_s = time.time() - t0
        out_bytes = sum(leaf.to_local().untyped_storage().nbytes()
                        if hasattr(leaf, "to_local") else leaf.untyped_storage().nbytes()
                        for _, leaf in named_leaves(_as_tree(out)) if torch.is_tensor(leaf))
        del out
    decode = kind == "decode"
    return {"step": kind, "counter": counter, "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes), "trace_s": trace_s,
            "cache_all_gathers": _cache_gathers(counter.calls, args[1]) if decode else None,
            "kv_rows_gather": _rows_gather(cspecs, args[1]) if decode else None}


def _run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Optional[str],
              rules_override: Optional[Dict[str, Any]] = None,
              tag: str = "", microbatches: int = 1,
              probes: bool = True, moments_dtype: str = "float32",
              cfg_overrides: Optional[Dict[str, Any]] = None,
              device: str = "cuda") -> Dict[str, Any]:
    del probes  # every layer runs: the counts are full-depth
    import torch
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch.roofline import active_param_count, model_flops, roofline_terms
    from repro_torch.models.param import count_params
    from repro_torch.models.registry import build_model

    t_start = time.time()
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = production_mesh(mesh_kind, device)
    chips = mesh.size()
    pspecs = build_model(cfg).param_specs()
    n_params = count_params(pspecs)

    rules = dict(DEFAULT_RULES)
    # big models: spread FSDP over the pod dim too, or the optimizer state
    # alone passes the card's budget
    if n_params * 10 / 256 > BUDGET_BYTES:
        rules["embed"] = ("pod", "data")
    if rules_override:
        rules.update({k: tuple(v) if isinstance(v, (list, tuple)) else (v,)
                      for k, v in rules_override.items()})

    t = trace_cell(cfg, shape, mesh, rules, device, microbatches, moments_dtype)
    kind, counter = t["step"], t["counter"]
    coll = counter.collectives()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "step": kind,
        "chips": chips, "ok": True, "tag": tag, "n_params": n_params,
        "compile_s": round(t["trace_s"], 2), "microbatches": microbatches,
        "device": device, "torch": torch.__version__,
        "argument_size_in_bytes": t["argument_size_in_bytes"],
        "output_size_in_bytes": t["output_size_in_bytes"],
        "temp_size_in_bytes": int(counter.peak),
        "peak_bytes_per_dev": int(t["argument_size_in_bytes"] + counter.peak),
        "flops_per_dev": float(counter.flops),
        "bytes_per_dev": float(counter.bytes),
        "coll_bytes_per_dev": float(coll["total"]),
        "collectives": coll,
        "largest_collectives": _largest(counter.calls),
        "cache_all_gathers": t["cache_all_gathers"],
        "kv_rows_gather": t["kv_rows_gather"],
        "probes": "full_depth",
        "rules": {k: list(v) if isinstance(v, tuple) else v for k, v in rules.items()},
    }
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    n_active = active_param_count(cfg, pspecs)
    rec["model_flops_global"] = model_flops(n_params, n_active, tokens, kind)
    rec["hlo_flops_global"] = rec["flops_per_dev"] * chips
    rec["useful_flops_ratio"] = (rec["model_flops_global"] / rec["hlo_flops_global"]
                                 if rec["hlo_flops_global"] else 0.0)
    rec.update(roofline_terms(flops_per_dev=rec["flops_per_dev"],
                              bytes_per_dev=rec["bytes_per_dev"],
                              coll_bytes_per_dev=rec["coll_bytes_per_dev"]))
    rec["wall_s"] = round(time.time() - t_start, 2)

    dist.destroy_process_group()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_kind}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _as_tree(out):
    """A step's output (a tensor, a tuple, dicts) as nested dicts."""
    if isinstance(out, dict):
        return {k: _as_tree(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return {str(i): _as_tree(v) for i, v in enumerate(out)}
    return out


def _largest(calls, n: int = 8):
    """The ``n`` largest collective calls: ``[name, operand shapes, dtypes,
    bytes, times issued]``, the same call counted once."""
    seen: Dict[tuple, list] = {}
    for name, shapes, dtypes, nbytes in calls:
        key = (name, tuple(map(tuple, shapes)), tuple(dtypes))
        if key in seen:
            seen[key][4] += 1
        else:
            seen[key] = [name, [list(s) for s in shapes], list(dtypes), nbytes, 1]
    return sorted(seen.values(), key=lambda r: -r[3])[:n]


def _cache_gathers(calls, cache) -> int:
    """How many all-gathers took a cache leaf's local shard (stacked, or one
    layer's) as their operand: a decode that gathers its cache."""
    from repro_torch.models.param import named_leaves

    shapes = set()
    for _, leaf in named_leaves(cache):
        local = tuple(leaf.to_local().shape)
        if len(local) >= 3:
            shapes.update({local, local[1:]})
    return sum(1 for name, ops_shapes, _, _ in calls
               if name == "all-gather" and any(tuple(s) in shapes for s in ops_shapes))


def _rows_gather(cspecs, cache) -> Dict[str, int]:
    """What making a decode cache's rows whole would gather on a rank, the
    all-gathers the split softmax removes: one a layer for every K / V leaf
    whose "kv_seq" rows the rules split over a mesh dim of size > 1, its
    local shard the operand.  ``{"calls", "bytes"}``."""
    from torch.distributed.tensor import Shard

    from repro_torch.models.param import named_leaves

    calls = nbytes = 0
    for (_, spec), (_, leaf) in zip(named_leaves(cspecs), named_leaves(cache)):
        if "kv_seq" not in spec.axes:
            continue
        d = spec.axes.index("kv_seq")
        if any(isinstance(p, Shard) and p.dim == d and leaf.device_mesh.size(m) > 1
               for m, p in enumerate(leaf.placements)):
            calls += spec.shape[0] if spec.axes[0] == "layers" else 1
            local = leaf.to_local()
            nbytes += local.numel() * local.element_size()
    return {"calls": calls, "bytes": nbytes}


def _cell_cmd(arch: str, shape: str, mesh_kind: str, out_dir: str, device: str):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
            "--mesh", mesh_kind, "--out", out_dir, "--device", device]


def _run_all(mesh_kinds, out_dir: str, archs=None, shapes=None, device: str = "cuda",
            jobs: int = 1, timeout_s: float = CELL_TIMEOUT_S) -> int:
    """Run every cell in a subprocess of its own with a time limit
    (``jobs`` at once); a failed cell leaves its output in ``<cell>.err``."""
    from repro_torch.configs import all_cells

    cells = all_cells()
    if archs:
        cells = [c for c in cells if c[0] in archs]
    if shapes:
        cells = [c for c in cells if c[1] in shapes]
    todo = []
    for mesh_kind in mesh_kinds:
        for arch, shape in cells:
            if os.path.exists(os.path.join(out_dir, f"{arch}_{shape}_{mesh_kind}.json")):
                print(f"[dryrun] skip cached {arch} x {shape} x {mesh_kind}")
                continue
            todo.append((arch, shape, mesh_kind))
    os.makedirs(out_dir, exist_ok=True)

    def one(cell):
        arch, shape, mesh_kind = cell
        try:
            r = subprocess.run(_cell_cmd(arch, shape, mesh_kind, out_dir, device),
                               capture_output=True, text=True, timeout=timeout_s)
            rc, out, err = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as te:
            out = te.stdout.decode() if isinstance(te.stdout, bytes) else (te.stdout or "")
            rc, err = 1, f"TIMEOUT after {timeout_s:.0f}s"
        if rc != 0:
            with open(os.path.join(out_dir, f"{arch}_{shape}_{mesh_kind}.err"), "w") as f:
                f.write(out[-4000:] + "\n" + err[-8000:])
            print(f"[dryrun] {arch} x {shape} x {mesh_kind} FAILED: "
                  f"{(err.strip().splitlines() or ['?'])[-1][:300]}", flush=True)
            return cell
        last = out.strip().splitlines()[-1] if out.strip() else "ok"
        print(f"[dryrun] {arch} x {shape} x {mesh_kind} {last}", flush=True)
        return None

    with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
        failures = [c for c in pool.map(one, todo) if c is not None]
    print(f"[dryrun] done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--rules", default=None, help="JSON logical-rule overrides")
    ap.add_argument("--tag", default="", help="suffix for perf-iteration records")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted; the counts are full-depth either way")
    ap.add_argument("--moments-dtype", default="float32")
    ap.add_argument("--cfg", default=None, help="JSON ModelConfig field overrides")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device type (nothing is allocated)")
    ap.add_argument("--jobs", type=int, default=1, help="cells at once under --all")
    args = ap.parse_args(argv)

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        return _run_all(mesh_kinds, args.out or DEFAULT_OUT,
                       archs=args.arch.split(",") if args.arch else None,
                       shapes=args.shape.split(",") if args.shape else None,
                       device=args.device, jobs=args.jobs)

    overrides = json.loads(args.rules) if args.rules else None
    for mk in mesh_kinds:
        try:
            rec = _run_cell(args.arch, args.shape, mk, args.out or DEFAULT_OUT, overrides,
                            args.tag, microbatches=args.microbatches,
                            probes=not args.no_probes, moments_dtype=args.moments_dtype,
                            cfg_overrides=json.loads(args.cfg) if args.cfg else None,
                            device=args.device)
            print(json.dumps({k: rec[k] for k in SUMMARY_KEYS if k in rec}), flush=True)
        except Exception:
            traceback.print_exc()
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
