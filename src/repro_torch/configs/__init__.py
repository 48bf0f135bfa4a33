"""Architecture configs of the port.  Each module exposes ``config()`` (the
published widths) and ``smoke_config()`` (a reduced same-family config).

The dry-run's cells are the reference's: its ten assigned archs (``bert_base_star``,
the paper's own proxy, is not one) under every shape, and ``long_500k`` only
for the sub-quadratic ones."""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

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


# the dry-run's archs, in the reference's order
CELL_ARCH_IDS: List[str] = [
    "granite_moe_1b_a400m", "mixtral_8x22b", "granite_8b", "qwen2_72b", "deepseek_coder_33b",
    "llama3_405b", "qwen2_vl_7b", "mamba2_130m", "seamless_m4t_large_v2", "recurrentgemma_2b",
]

# long_500k runs only for the sub-quadratic archs (a sliding window caps
# mixtral's cache)
LONG_CONTEXT_ARCHS = {"mixtral_8x22b", "mamba2_130m", "recurrentgemma_2b"}


def shapes_for(arch: str) -> List[str]:
    arch = arch.replace("-", "_")
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out


def all_cells() -> List[tuple]:
    """Every dry-run ``(arch, shape)`` cell: 33."""
    return [(a, s) for a in CELL_ARCH_IDS for s in shapes_for(a)]
