"""Model registry: family -> implementation class (dense, moe, vlm and ssm
so far)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import MambaLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return MambaLM(cfg)
    raise ValueError(f"family {cfg.family!r} is not ported yet (dense, moe, vlm and ssm only)")
