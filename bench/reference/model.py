"""The plain reference of the benchmark's decoder LMs (``"reference":
"model"``): float32 PyTorch, one sequence at a time, layer by layer, under
the contract of :mod:`reference.common`.

It follows the published architecture of the configurations that name it:
token embedding, then per layer RMSNorm, grouped-query attention with
half-split RoPE and the STAR softmax on the scores (``scores * D**-0.5``,
causal), the output projection and the residual, RMSNorm, and a SwiGLU MLP
or a top-k mixture of experts with a STAR router (:func:`reference.common.moe`);
a final RMSNorm and the unembedding, whose columns past the vocabulary are
masked.  Untied weights, no biases, windows, multipliers or shared experts.

The weights are the tensors the benchmark drew (stored in bfloat16, norm
scales in float32); each layer's are taken to float32 when that layer runs,
so the whole model never sits in float32 at once.  Under the control
(:data:`reference.common.FLOAT8`) the activations held in bfloat16 are the
embedding rows, each norm's and each projection's output, the rotated q and
k, the attention output, the residual stream after each add and the logits.

Its work counts are the yardstick's for attention plus an MLP or experts in
every layer, each layer holding K/V (``harness.work``).
"""

from __future__ import annotations

from typing import Sequence

import torch

# the contract's work counts: the yardstick's, re-exported
from harness.work import decode_flops, flash_least_s, paged_least_s, prefill_flops  # noqa: F401
from reference.common import (FLOAT32, MASKED_LOGIT, Precision, attention, mlp, moe, rmsnorm,
                              rope, tf32_off)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def logits(weights: dict, model: dict, fmt: Sequence[int], tokens: torch.Tensor,
           prompt_len: int, out_rows: torch.Tensor, prec: Precision = FLOAT32,
           q_block: int = 256) -> torch.Tensor:
    """Logits ``[len(out_rows), padded vocab]`` of one causal sequence
    ``tokens`` ``[N]`` (a prompt of ``prompt_len`` tokens followed by
    generated ones), at the positions ``out_rows``, as float32 tensors."""
    with tf32_off(), torch.no_grad():
        hq, hkv = model["num_heads"], model["num_kv_heads"]
        d = model["d_model"]
        hd = model.get("head_dim") or d // hq
        eps, theta = model["norm_eps"], model["rope_theta"]
        n = tokens.numel()
        pos = torch.arange(n, device=tokens.device)
        r = prec.held
        h = r(weights["embed"]["table"][tokens])
        for i in range(model["num_layers"]):
            bp = _layer(weights["blocks"], i)
            x = r(rmsnorm(h, bp["ln1"]["scale"], eps))
            a = bp["attn"]
            q = r(rope(prec.mm(x, a["wq"]).reshape(n, hq, hd), pos, theta))
            k = r(rope(prec.mm(x, a["wk"]).reshape(n, hkv, hd), pos, theta))
            v = prec.mm(x, a["wv"]).reshape(n, hkv, hd)
            ctx = r(attention(q, k, v, fmt, q_block).reshape(n, hq * hd))
            h = r(h + prec.mm(ctx, a["wo"]))
            x = r(rmsnorm(h, bp["ln2"]["scale"], eps))
            if "moe" in bp:
                h = r(h + moe(x, bp["moe"], model, fmt, prompt_len, prec))
            else:
                h = r(h + mlp(x, bp["mlp"], prec))
        x = r(rmsnorm(h[out_rows], weights["final_norm"]["scale"], eps))
        out = prec.mm(x, weights["unembed"]["kernel"])
        vocab = model["vocab_size"]
        if out.shape[-1] != vocab:
            out[:, vocab:] = MASKED_LOGIT
        return out
