"""Model registry: family -> implementation class (every family of the
reference: dense, moe, vlm, ssm, hybrid and encdec)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.rglru import RecurrentGemmaLM
from repro_torch.models.ssm import MambaLM
from repro_torch.models.transformer import DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return MambaLM(cfg)
    if cfg.family == "hybrid":
        return RecurrentGemmaLM(cfg)
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r} (dense, moe, vlm, ssm, hybrid, encdec)")
