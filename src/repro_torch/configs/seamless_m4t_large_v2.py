"""seamless-m4t-large-v2 [arXiv:2308.11596; hf] — enc-dec, multimodal.
24L(enc) + 24L(dec) d_model=1024 16H (GQA kv=16: head_dim 64) d_ff=8192
(GELU) vocab=256206 (padded to 256512).  The audio frontend is a stub, as in
the reference: a request brings precomputed frame embeddings of width
``frontend_dim`` that ``frontend_proj`` projects into the encoder."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=24,
        num_decoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        mlp_type="gelu",
        frontend_dim=1024,
        param_dtype="float32",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke",
        family="encdec",
        num_layers=2,
        num_decoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        mlp_type="gelu",
        frontend_dim=32,
        attn_block_size=32,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
