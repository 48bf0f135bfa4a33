"""Deterministic synthetic data (port of ``repro.data.synthetic``; numpy
only, so its batches are bit for bit the reference's).

A reproducible, shardable token source: a per-(step, shard) seeded mixture
of an order-2 Markov chain over a small latent alphabet projected onto the
vocabulary, and uniform noise.  Learnable structure, so training curves
move, with no external data.  Every batch is a pure function of (seed,
step, shard): a restarted run regenerates the batches it had not consumed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    latent: int = 64  # Markov alphabet
    noise: float = 0.1
    order: int = 2


def _latent_chain(rng: np.random.Generator, n: int, k: int, order: int, noise: float):
    """Order-``order`` Markov chain over ``k`` symbols: ``next = (5 prev1 +
    7 prev2 + 3) % k``, with random hops at rate ``noise``."""
    a, b, c = 5, 7, 3
    seq = np.empty(n, dtype=np.int64)
    seq[:order] = rng.integers(0, k, order)
    hops = rng.random(n) < noise
    rnd = rng.integers(0, k, n)
    for i in range(order, n):
        seq[i] = rnd[i] if hops[i] else (a * seq[i - 1] + b * seq[i - 2] + c) % k
    return seq


def make_batch(
    model_cfg: ModelConfig,
    *,
    batch: int,
    seq_len: int,
    step: int,
    shard: int = 0,
    data_cfg: DataConfig = DataConfig(),
) -> Dict[str, np.ndarray]:
    """One batch: ``tokens`` and next-token ``labels`` ``[B, T]`` int32, and
    the stub frontend inputs of the vlm (``patch_embeds`` ``[B, P,
    frontend_dim]``) and encdec (``src_embeds`` ``[B, max(8, T // 4),
    frontend_dim]``) families, float32."""
    rng = np.random.default_rng(np.random.SeedSequence([data_cfg.seed, step, shard]))
    k = min(data_cfg.latent, model_cfg.vocab_size)
    toks = np.stack([_latent_chain(rng, seq_len + 1, k, data_cfg.order, data_cfg.noise)
                     for _ in range(batch)])
    # the latent symbols spread over the vocabulary
    stride = max(1, model_cfg.vocab_size // (k + 1))
    toks = (toks * stride) % model_cfg.vocab_size
    out: Dict[str, np.ndarray] = {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
    if model_cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (batch, model_cfg.num_patches, model_cfg.frontend_dim or model_cfg.d_model),
            dtype=np.float32)
    if model_cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal(
            (batch, max(8, seq_len // 4), model_cfg.frontend_dim or model_cfg.d_model),
            dtype=np.float32)
    return out


def batch_iterator(
    model_cfg: ModelConfig,
    *,
    batch: int,
    seq_len: int,
    start_step: int = 0,
    shard: int = 0,
    data_cfg: DataConfig = DataConfig(),
) -> Iterator[Dict[str, np.ndarray]]:
    """``make_batch`` for ``start_step``, ``start_step + 1``, ... without end."""
    step = start_step
    while True:
        yield make_batch(model_cfg, batch=batch, seq_len=seq_len, step=step, shard=shard,
                         data_cfg=data_cfg)
        step += 1
