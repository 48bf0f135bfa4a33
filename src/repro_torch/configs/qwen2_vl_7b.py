"""qwen2-vl-7b [arXiv:2409.12191; hf] — M-RoPE, dynamic resolution.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
The vision frontend is a stub, as in the reference: a request brings
precomputed patch embeddings (ViT output width 1280) that ``patch_proj``
projects and prepends; M-RoPE sections (16, 24, 24) over the 64-dim rotary
half.  About 7.62 B parameters: it fits one card at its published widths."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
        mrope_sections=(16, 24, 24),
        num_patches=256,
        frontend_dim=1280,
        seq_parallel_activations=True,
        param_dtype="float32",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        mrope_sections=(4, 2, 2),
        num_patches=16,
        frontend_dim=32,
        attn_block_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
