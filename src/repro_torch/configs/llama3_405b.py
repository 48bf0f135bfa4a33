"""llama3-405b [arXiv:2407.21783; unverified] — GQA, 128k vocab.
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
About 406 B parameters: the full config does not fit one card, so the port
runs it at its smoke config, whose head_dim is 8 (d_model 64 over 8 heads,
2 KV heads: a GQA group of 4)."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=500000.0,
        seq_parallel_activations=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke",
        family="dense",
        num_layers=3,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=256,
        attn_block_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
