"""Training launcher of the port: one device, the card by default.

  # bert-base-star at its published widths on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert_base_star \\
      --steps 20 --batch 8 --seq 512 --ckpt-dir build/ckpt

  # a smoke config on the CPU (the plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b --smoke \\
      --device cpu --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

The flags are the reference's, with ``--device`` added.  ``--mesh`` and
``--multihost`` (sharded and multi-host training) raise
``MeshNotPortedError``: the mesh code is not ported.
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
    ap.add_argument("--mesh", default=None, help="e.g. '4,2' => (data,model): not ported")
    ap.add_argument("--multihost", action="store_true", help="not ported")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.train.loop import LoopConfig, refuse_mesh, run_train

    if args.mesh or args.multihost:
        refuse_mesh("--mesh / --multihost")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    res = run_train(
        cfg,
        train_config(args.steps, args.lr, args.microbatches),
        LoopConfig(num_steps=args.steps, batch=args.batch, seq_len=args.seq,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        device=args.device,
    )
    print(f"final loss: {res['history'][-1]['loss']:.4f} after {res['final_step']} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
