"""granite-8b [arXiv:2405.04324; hf] — llama-arch code model.
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.ops.specs import AttentionSpec, SoftmaxSpec

STAR_GATHER = SoftmaxSpec(kind="star", mode="gather")


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        rope_theta=10000.0,
        attention=AttentionSpec(impl="xla", softmax=STAR_GATHER, block_kv=512),
        param_dtype="float32",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attention=AttentionSpec(
            impl="xla", softmax=STAR_GATHER, block_k=32, block_kv=32
        ),
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
