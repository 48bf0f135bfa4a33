"""mixtral-8x22b [arXiv:2401.04088; hf]
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
About 141 B parameters: the full config does not fit one card, so the port
runs it at its smoke config (MoE, a window of 16, GQA).  ``moe_style="tp"``
names the reference's column-parallel expert sharding; on one card it
changes nothing."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        num_experts=8,
        top_k=2,
        moe_style="tp",
        sliding_window=4096,
        rope_theta=1000000.0,
        seq_parallel_activations=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        num_experts=4,
        top_k=2,
        moe_style="tp",
        sliding_window=16,
        attn_block_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
