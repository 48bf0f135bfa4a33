"""qwen2-72b [arXiv:2407.10671; hf] — GQA with QKV bias.
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
About 72.7 B parameters: the full config does not fit one card, so the port
runs it at its smoke config."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
        seq_parallel_activations=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        qkv_bias=True,
        attn_block_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
