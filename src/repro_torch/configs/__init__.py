"""Architecture configs of the port.  Each module exposes ``config()`` (the
published widths) and ``smoke_config()`` (a reduced same-family config)."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCH_IDS: List[str] = [
    "bert_base_star", "deepseek_coder_33b", "granite_8b", "granite_moe_1b_a400m", "llama3_405b",
    "mamba2_130m", "mixtral_8x22b", "qwen2_72b", "qwen2_vl_7b", "recurrentgemma_2b",
    "seamless_m4t_large_v2",
]


def _mod(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported yet; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke_config()
