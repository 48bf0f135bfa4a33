"""recurrentgemma-2b [arXiv:2402.19427; hf] — RG-LRU + local attn, 1:2.
26L d_model=2560 10H (GQA kv=1 = MQA: head_dim 256) d_ff=7680 vocab=256000.
Pattern (recurrent, recurrent, attention): 8 periods + a 2-layer recurrent
tail, so 18 RG-LRU blocks and 8 local-attention blocks over a window of
2048.  About 3.5 B parameters: it fits one card at its published widths."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        block_pattern=("recurrent", "recurrent", "attention"),
        lru_width=2560,
        local_window=2048,
        conv_width=4,
        rope_theta=10000.0,
        param_dtype="float32",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        num_layers=5,  # 1 period + 2-layer tail
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=256,
        block_pattern=("recurrent", "recurrent", "attention"),
        lru_width=64,
        local_window=16,
        conv_width=4,
        attn_block_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
