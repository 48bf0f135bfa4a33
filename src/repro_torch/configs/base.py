"""Model configuration (port of ``repro.configs.base``: the dense, moe, ssm,
hybrid, encdec and vlm fields, and ``remat``).

A config carries its op contract as ``repro_torch.ops`` specs; the legacy
loose fields (``softmax_kind``, ``attn_impl``, ...) stay as constructor
inputs that the ``*_spec`` properties fold in, so the reference's
``dataclasses.replace(cfg, attn_impl="pallas")`` idiom means the same here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.ops.specs import AttentionSpec, PagedAttentionSpec, SoftmaxSpec

# legacy attn_impl names -> registry impls (new names pass through)
_ATTN_IMPLS = {"naive": "reference", "blocked": "xla", "flash": "pallas"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    mlp_type: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # names the reference's sharding of the experts (tp: expert weights
    # column-parallel; ep: expert-parallel); on one card it changes nothing
    moe_style: str = "tp"
    star_router: bool = True  # the router's softmax through the STAR engine too

    # --- hybrid (recurrentgemma: RG-LRU blocks beside local attention) ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("recurrent", "recurrent", "attention")
    lru_width: Optional[int] = None  # RG-LRU width (None: d_model)
    local_window: int = 2048  # the attention blocks' sliding window
    conv_width: int = 4  # the recurrent blocks' causal conv

    # --- enc-dec (seamless: stub frame embeddings) ---
    num_decoder_layers: int = 0  # num_layers counts the encoder's

    # --- vlm (qwen2-vl: stub patch embeddings, M-RoPE) ---
    frontend_dim: Optional[int] = None  # stub patch (vlm) or frame (encdec) embedding width
    num_patches: int = 0  # stub patch positions prepended
    mrope_sections: Tuple[int, ...] = ()  # M-RoPE split of the rotary half-dim (t, h, w)

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_ngroups: int = 1

    softmax: Optional[SoftmaxSpec] = None
    attention: Optional[AttentionSpec] = None
    # Legacy loose fields (used when the specs above are None, and as
    # overrides when moved off their defaults).
    softmax_kind: str = "star"
    softmax_int_bits: int = 6
    softmax_frac_bits: int = 2
    softmax_mode: str = "gather"
    attn_impl: str = "blocked"
    attn_block_size: int = 512

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # under a mesh, shard the q rows and the carry between blocks over the
    # model dim ("act_seq") instead of leaving them replicated
    seq_parallel_activations: bool = False
    # training: recompute each block's forward in the backward pass
    # (``torch.utils.checkpoint``) instead of keeping its activations
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/unembedding width: vocab padded to a multiple of 512.
        Padded logit columns are masked in ``unembed``."""
        return -(-self.vocab_size // 512) * 512

    @property
    def softmax_format(self) -> FixedPointFormat:
        """The softmax's format: the spec's, or (an exact spec has none) the
        legacy bit fields'."""
        fmt = self.softmax_spec.fmt
        if fmt is not None:
            return fmt
        return FixedPointFormat(self.softmax_int_bits, self.softmax_frac_bits)

    @property
    def softmax_config(self):
        """Deprecated: the pre-dispatch ``core.attention.SoftmaxConfig``."""
        from repro_torch.core.attention import SoftmaxConfig  # core imports the ops layer

        return SoftmaxConfig.from_spec(self.softmax_spec)

    @property
    def softmax_spec(self) -> SoftmaxSpec:
        base = self.softmax
        if base is None and self.attention is not None:
            base = self.attention.softmax
        if base is None:
            return SoftmaxSpec(
                kind=self.softmax_kind, mode=self.softmax_mode,
                precision=FixedPointFormat(self.softmax_int_bits, self.softmax_frac_bits),
            )
        updates = {}
        if self.softmax_kind != "star":
            updates["kind"] = self.softmax_kind
        if self.softmax_mode != "gather":
            updates["mode"] = self.softmax_mode
        if (self.softmax_int_bits, self.softmax_frac_bits) != (6, 2):
            updates["precision"] = FixedPointFormat(
                self.softmax_int_bits, self.softmax_frac_bits
            )
        return dataclasses.replace(base, **updates) if updates else base

    @property
    def attention_spec(self) -> AttentionSpec:
        if self.attention is None:
            return AttentionSpec(
                impl=_ATTN_IMPLS.get(self.attn_impl, self.attn_impl),
                softmax=self.softmax_spec,
                block_k=min(self.attn_block_size, 128),
                block_kv=self.attn_block_size,
            )
        updates = {"softmax": self.softmax_spec}
        if self.attn_impl != "blocked":
            updates["impl"] = _ATTN_IMPLS.get(self.attn_impl, self.attn_impl)
        if self.attn_block_size != 512:
            updates["block_k"] = min(self.attn_block_size, 128)
            updates["block_kv"] = self.attn_block_size
        return dataclasses.replace(self.attention, **updates)

    @property
    def paged_attention_spec(self) -> PagedAttentionSpec:
        """Paged decode contract: ``pallas`` maps to the gather-free
        ``pallas_paged`` kernel, ``reference``/``xla`` keep their gather
        adapters, anything else falls back to ``xla``."""
        base = self.attention_spec
        impl = {"reference": "reference", "xla": "xla",
                "pallas": "pallas_paged"}.get(base.impl, "xla")
        return PagedAttentionSpec(impl=impl, softmax=base.softmax, block_k=base.block_k)

    def validate(self) -> "ModelConfig":
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(
                f"GQA needs num_heads % num_kv_heads == 0, got "
                f"{self.num_heads} % {self.num_kv_heads}"
            )
        if self.family == "moe" and (self.num_experts <= 0 or self.top_k <= 0):
            raise ValueError(f"the moe family needs num_experts > 0 and top_k > 0, got "
                             f"{self.num_experts} and {self.top_k}")
        if self.family == "ssm" and self.ssm_state <= 0:
            raise ValueError(f"the ssm family needs ssm_state > 0, got {self.ssm_state}")
        if self.family == "hybrid" and not self.block_pattern:
            raise ValueError("the hybrid family needs a block_pattern")
        if self.family == "encdec" and self.num_decoder_layers <= 0:
            raise ValueError(f"the encdec family needs num_decoder_layers > 0, got "
                             f"{self.num_decoder_layers}")
        half = self.resolved_head_dim // 2
        if self.mrope_sections and sum(self.mrope_sections) != half:
            # the reference asserts this inside apply_mrope; here at build time
            raise ValueError(f"mrope_sections {self.mrope_sections} must sum to head_dim // 2 "
                             f"= {half}")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry-run (port of the reference's
    ``ShapeConfig``): a step kind at a sequence length and a global batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
