"""Abstract inputs for every (arch x shape) dry-run cell (port of
``repro.launch.specs``).

``input_specs(cfg, shape)`` returns ``(step_kind, inputs)``: the same step
kinds, keys and leaves as the reference, each leaf a tensor on the ``meta``
device (shape and dtype, no storage), so nothing is allocated.  The dry-run
turns them into fake tensors placed on its mesh and runs the cell's step
on them.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import ops
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.param import shape_tree
from repro_torch.models.registry import build_model
from repro_torch.train.state import state_shapes

# decode-time encoder memory length for enc-dec (30 s of audio at 50 frames
# a second is ~1500; rounded up to a shardable 4096)
ENCDEC_DECODE_SRC_LEN = 4096
# prefill cell: the decoder prompt is one BOS token; the self cache is small
ENCDEC_PREFILL_SELF_CACHE = 1024


def abstract(shape, dtype: torch.dtype) -> torch.Tensor:
    """A ``meta`` tensor: the shape and dtype of an input, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training batch stand-ins."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.family == "vlm":
        # the patch prefix and the text tokens sum to the cell's seq_len
        text = s - cfg.num_patches
        out["tokens"] = abstract((b, text), torch.int32)
        out["labels"] = abstract((b, text), torch.int32)
        out["patch_embeds"] = abstract((b, cfg.num_patches, cfg.frontend_dim), torch.float32)
    elif cfg.family == "encdec":
        out["tokens"] = abstract((b, s), torch.int32)
        out["labels"] = abstract((b, s), torch.int32)
        out["src_embeds"] = abstract((b, s, cfg.frontend_dim or cfg.d_model), torch.float32)
    else:
        out["tokens"] = abstract((b, s), torch.int32)
        out["labels"] = abstract((b, s), torch.int32)
    return out


def cache_spec(model, cfg: ModelConfig, shape: ShapeConfig):
    """The decode cell's cache spec tree: ``seq_len`` rows (an enc-dec's
    cross cache holds :data:`ENCDEC_DECODE_SRC_LEN`)."""
    if cfg.family == "encdec":
        return model.cache_spec(shape.global_batch, shape.seq_len, src_len=ENCDEC_DECODE_SRC_LEN)
    return model.cache_spec(shape.global_batch, shape.seq_len)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[str, Dict[str, Any]]:
    """``(step_kind, {name: abstract value})`` for the cell."""
    # capability-check the config's op specs before building anything: a
    # backend the registry cannot serve fails here, with its own error
    ops.validate(cfg.attention_spec)
    ops.validate(cfg.softmax_spec)
    model = build_model(cfg)
    pspecs = model.param_specs()
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        return "train", {"state": state_shapes(pspecs),
                         "batch": batch_specs(cfg, shape)}

    params = shape_tree(pspecs)
    if shape.kind == "prefill":
        inputs: Dict[str, Any] = {"params": params}
        if cfg.family == "encdec":
            inputs["tokens"] = abstract((b, 1), torch.int32)
            inputs["src_embeds"] = abstract((b, s, cfg.frontend_dim or cfg.d_model),
                                            torch.float32)
            inputs["_max_len"] = ENCDEC_PREFILL_SELF_CACHE
        elif cfg.family == "vlm":
            inputs["tokens"] = abstract((b, s - cfg.num_patches), torch.int32)
            inputs["patch_embeds"] = abstract((b, cfg.num_patches, cfg.frontend_dim),
                                              torch.float32)
            inputs["_max_len"] = s + 1
        else:
            inputs["tokens"] = abstract((b, s), torch.int32)
            inputs["_max_len"] = s + 1
        return "prefill", inputs

    # decode: one new token against a seq_len-deep cache
    return "decode", {"params": params,
                      "cache": shape_tree(cache_spec(model, cfg, shape)),
                      "tokens": abstract((b, 1), torch.int32)}
