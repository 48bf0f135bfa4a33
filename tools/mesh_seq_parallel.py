#!/usr/bin/env python3
"""A forward with ``seq_parallel_activations`` under a one-rank ``(1, 1)``
mesh against the same forward without the mesh (granite-8b's smoke config,
[4, 64] tokens, every attention route).

Under the mesh the q rows and the carry between blocks are sharded along
their rows ("act_seq" over "model") beside the batch ("data"), so each
projection's input has two sharded leading dims.  Prints the largest
difference of the logits per route, or the error a route raised, and exits
1 if any route failed.  Runs on the card (NCCL) unless given ``--device
cpu`` (gloo); run from the root of a checkout:

    python3 tools/mesh_seq_parallel.py [--device cpu]
"""

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES, distribute, param_shardings, sharding_of, use_mesh_rules)
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.models.param import materialize
    from repro_torch.models.registry import build_model

    print(f"torch {torch.__version__}", flush=True)
    init_process_group(args.device, store=dist.HashStore())
    failed = 0
    try:
        mesh = make_mesh((1, 1), ("data", "model"), args.device)
        cfg = dataclasses.replace(get_smoke_config("granite_8b"), seq_parallel_activations=True)
        model = build_model(cfg)
        specs = model.param_specs()
        params = materialize(specs, 0, args.device)
        dparams = distribute(params, param_shardings(specs, DEFAULT_RULES, mesh))
        gen = torch.Generator(device=args.device).manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device=args.device)
        dtoks = sharding_of(("batch", "seq"), toks.shape, DEFAULT_RULES, mesh).place(toks)
        for impl in ("xla", "pallas", "reference"):
            try:
                with torch.no_grad(), ops.use(attention=impl):
                    want = model.forward(params, toks)
                    with use_mesh_rules(mesh, DEFAULT_RULES):
                        got = model.forward(dparams, dtoks).full_tensor()
                print(f"{impl}: max |logits - unsharded| {float((got - want).abs().max()):.3e}")
            except Exception as exc:  # report every route, then fail
                failed += 1
                print(f"{impl}: FAILED {type(exc).__name__}: {str(exc).splitlines()[0][:300]}")
    finally:
        dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
