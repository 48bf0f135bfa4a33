"""End-to-end training on the PyTorch / H100 port: a ~100M-parameter
STAR-attention LM for a few hundred steps on the synthetic pipeline, with
checkpointing, as ``train_lm_star.py`` runs it for the JAX package.

Full run (~100M params, 300 steps of 8 x 512 tokens) on the card:
    PYTHONPATH=src python examples/torch_train_lm_star.py --full
Default quick run (scaled-down model, same code path):
    PYTHONPATH=src python examples/torch_train_lm_star.py
On the CPU (any size, slowly):
    PYTHONPATH=src python examples/torch_train_lm_star.py --device cpu --steps 10

Softmax ``star_ste``: quantization-aware training on STAR (the STAR forward,
a straight-through backward), float32 throughout.  The last line reports the
mean loss of the first and last steps, which must fall.
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import count_params
from repro_torch.models.registry import build_model
from repro_torch.train.loop import LoopConfig, run_train
from repro_torch.train.step import TrainConfig


def model_100m() -> ModelConfig:
    # ~103M params: 12L, d=640, untied embeddings, 32k vocab
    return ModelConfig(
        name="star-lm-100m", family="dense",
        num_layers=12, d_model=640, num_heads=10, num_kv_heads=5,
        d_ff=2560, vocab_size=32768,
        softmax_kind="star_ste",  # quantization-aware training on STAR
        param_dtype="float32", compute_dtype="float32", remat=False,
    )


def model_small() -> ModelConfig:
    return dataclasses.replace(
        model_100m(), num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
        d_ff=1024, vocab_size=2048, name="star-lm-small",
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="~100M params, 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)

    dev = ops.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_100m() if args.full else model_small()
    steps = args.steps or (300 if args.full else 60)
    batch, seq = (8, 512) if args.full else (8, 128)

    n = count_params(build_model(cfg).param_specs())
    print(f"model: {cfg.name}  params: {n / 1e6:.1f}M  softmax: {cfg.softmax_kind} "
          f"({cfg.softmax_spec.fmt.short_name()})  device: {dev}")

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="star_lm_")
    res = run_train(
        cfg,
        TrainConfig(peak_lr=6e-4, warmup_steps=max(10, steps // 20), total_steps=steps),
        LoopConfig(num_steps=steps, batch=batch, seq_len=seq,
                   ckpt_dir=ckpt, ckpt_every=max(25, steps // 4), log_every=10),
        device=dev,
    )
    span = max(1, min(5, len(res["history"]) // 2))
    first = sum(h["loss"] for h in res["history"][:span]) / span
    last = sum(h["loss"] for h in res["history"][-span:]) / span
    print(f"\nloss {first:.3f} -> {last:.3f} over {res['final_step']} steps "
          f"(checkpoints in {ckpt})")
    assert last < first, "training must make progress"


if __name__ == "__main__":
    main()
