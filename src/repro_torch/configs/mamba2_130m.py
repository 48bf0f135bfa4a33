"""mamba2-130m [arXiv:2405.21060; unverified] — SSD (state-space duality).
24L d_model=768 (attn-free) vocab=50280, ssm_state=128.
d_inner = 1536, headdim 64 -> 24 SSD heads.  The paper's softmax engine is
inapplicable to the mixer (no softmax); STAR shapes only the sampling
distribution."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=24,
        num_kv_heads=24,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=128,
        param_dtype="float32",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_headdim=32,
        ssm_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
