"""bert-base-star [arXiv:1810.04805] — the paper's own evaluation model.
12L d_model=768 12H (kv=12: head_dim 64) d_ff=3072 (GELU) vocab=30522
(padded to 30720).  The paper profiles softmax latency and accuracy on
BERT-base over CNEWS / MRPC / CoLA; as in the reference it is carried as a
causal-LM-shaped config.  The softmax precision is the named policy
``"auto:cnews"``, resolved through ``core.precision.policy_for`` (the
paper's calibrated per-dataset format table).  About 132 M float32
parameters: it trains at its published widths on one card."""

from repro_torch.configs.base import ModelConfig
from repro_torch.ops.specs import SoftmaxSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="bert-base-star",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=30522,
        mlp_type="gelu",
        softmax=SoftmaxSpec(kind="star", mode="histogram", precision="auto:cnews"),
        param_dtype="float32",
        compute_dtype="float32",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="bert-base-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        mlp_type="gelu",
        softmax=SoftmaxSpec(kind="star", mode="histogram", precision="auto:cnews"),
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
