"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
``moe_style="ep"`` names the reference's expert-parallel sharding; on one
card it changes nothing."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        num_experts=32,
        top_k=8,
        moe_style="ep",
        rope_theta=10000.0,
        param_dtype="float32",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        num_experts=8,
        top_k=2,
        moe_style="ep",
        attn_block_size=64,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
