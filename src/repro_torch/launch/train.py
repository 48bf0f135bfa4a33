"""Training launcher of the port: the card by default, one device or a mesh.

  # bert-base-star at its published widths on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert_base_star \\
      --steps 20 --batch 8 --seq 512 --ckpt-dir build/ckpt

  # a smoke config on the CPU (the plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b --smoke \\
      --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

  # sharded over a (data, model) mesh: one process under a one-rank group
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b --smoke --mesh 1,1

  # four ranks, one a process, on the CPU (gloo) or four cards (NCCL)
  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train \\
      --arch granite_8b --smoke --mesh 2,2 --multihost --device cpu

The flags are the reference's, with ``--device`` added.  ``--mesh 'd,m'``
(or ``'p,d,m'`` with a pod dim) trains sharded by the default logical
rules.  ``--multihost`` joins the process group that ``torchrun`` describes
in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``); without it the launcher is the only rank, on a store in
its own memory.  Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import sys


def train_config(steps: int, lr: float = 3e-4, microbatches: int = 1):
    """The ``TrainConfig`` the launcher runs: a cosine schedule over
    ``steps`` with a tenth of them (at least one) of warmup."""
    from repro_torch.train.step import TrainConfig

    return TrainConfig(peak_lr=lr, total_steps=steps, warmup_steps=max(1, steps // 10),
                       microbatches=microbatches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default=None, help="e.g. '4,2' => (data,model)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes in the environment")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.train.loop import LoopConfig, run_train

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rank0 = True
    mesh = None
    sharded = bool(args.mesh or args.multihost)
    try:
        if sharded:
            mesh, rank0 = _mesh_for(args.mesh, args.multihost, args.device)
        res = run_train(
            cfg,
            train_config(args.steps, args.lr, args.microbatches),
            LoopConfig(num_steps=args.steps, batch=args.batch, seq_len=args.seq,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
            mesh=mesh,
            log_fn=print if rank0 else (lambda *_: None),
            device=None if mesh is not None else args.device,
        )
    finally:
        import torch.distributed as dist

        if sharded and dist.is_initialized():
            dist.destroy_process_group()
    if rank0:
        print(f"final loss: {res['history'][-1]['loss']:.4f} after {res['final_step']} steps")
    return 0


def _mesh_for(spec, multihost: bool, device):
    """``(mesh, whether this is rank 0)``: the process group from the
    environment (``--multihost``) or a one-rank group on a ``HashStore``,
    and the ``--mesh`` over it (default: every rank on the data dim)."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh

    if multihost:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"--multihost reads {missing} from the environment "
                               "(torchrun sets them)")
        init_process_group(device, rank=int(os.environ["RANK"]),
                           world_size=int(os.environ["WORLD_SIZE"]), init_method="env://")
    else:
        init_process_group(device, store=dist.HashStore())
    shape = (tuple(int(x) for x in spec.split(",")) if spec
             else (dist.get_world_size(), 1))
    axes = ("data", "model")[: len(shape)] if len(shape) <= 2 else ("pod", "data", "model")
    return make_mesh(shape, axes, device), dist.get_rank() == 0


if __name__ == "__main__":
    sys.exit(main())
