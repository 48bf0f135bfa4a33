"""deepseek-coder-33b [arXiv:2401.14196; hf] — llama-arch.
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
About 33.3 B parameters: the full config does not fit one card, so the port
runs it at its smoke config, whose head_dim is 8 (d_model 56 over 7 heads,
one KV head: a GQA group of 7)."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        num_layers=62,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        rope_theta=100000.0,
        seq_parallel_activations=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke",
        family="dense",
        num_layers=2,
        d_model=56,
        num_heads=7,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        attn_block_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
