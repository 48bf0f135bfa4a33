"""The plain reference of the benchmark's decoder LMs: float32 PyTorch, one
sequence at a time, layer by layer.

It follows the published architecture of the configurations the benchmark
runs: token embedding, then per layer RMSNorm, grouped-query attention with
half-split RoPE and the STAR softmax on the scores (``scores * D**-0.5``,
causal), the output projection and the residual, RMSNorm, and a SwiGLU MLP
or a top-k mixture of experts with a STAR router; a final RMSNorm and the
unembedding, whose columns past the vocabulary are masked.  The MoE block
follows GShard-style capacity: the prompt's rows are one group whose expert
queues hold ``max(1, int(capacity_factor * top_k * rows / experts))`` choices
in (row, choice) order, later choices dropped; each generated row is a group
of its own, which drops nothing.  Gates are the top-k probabilities (ties to
the lower expert) divided by their sum; a dropped choice weighs 0.

The weights are the tensors the benchmark drew (stored in bfloat16, norm
scales in float32); each layer's are taken to float32 when that layer runs,
so the whole model never sits in float32 at once.  TF32 is off for the
duration of a call.

``prec`` says in what the model computes.  :data:`FLOAT32` is the
reference.  :data:`FLOAT8` is the control: the configuration's bfloat16
program with its products taken one precision lower, to float8 e4m3, the
step a faster program would take.  Both operands of every projection (the
weight, and the activation it multiplies: a norm's output, the attention
output, the MLP's and the experts' intermediates) are rounded to float8
with one scale per tensor, and the product accumulates in float32.  Every
activation the program holds in its compute dtype (the embedding rows,
each norm's and each projection's output, the rotated q and k, the
attention output, the residual stream after each add, the logits) is
rounded to bfloat16, as the program holds it.  Attention's own products,
the norms and the softmaxes run in float32 on those values.

Nothing here imports the program or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Sequence

import torch

from reference.star import star_softmax

MASKED_LOGIT = -1e30  # the unembedding's columns past the vocabulary
FP8_MAX = 448.0  # largest float8 e4m3 value


def _same(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    held: Callable[[torch.Tensor], torch.Tensor]  # an activation the program holds
    operand: Callable[[torch.Tensor], torch.Tensor]  # a projection's operand

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.held(self.operand(x) @ self.operand(w))


FLOAT32 = Precision("float32", _same, _same)
FLOAT8 = Precision("float8_e4m3 products, bfloat16 activations", _bf16, _fp8)


@contextlib.contextmanager
def tf32_off():
    """Float32 products in float32: TF32 off while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[N, H, D]`` rotated by ``positions`` ``[N]``, halves split."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fmt, q_block: int
              ) -> torch.Tensor:
    """Causal STAR attention, q ``[N, Hq, D]`` over k / v ``[N, Hkv, D]``
    (head ``h`` reads KV head ``h // (Hq // Hkv)``), in blocks of query rows
    so that the scores of a long sequence fit."""
    n, hq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty_like(q)
    for r0 in range(0, n, q_block):
        r1 = min(n, r0 + q_block)
        qb = q[r0:r1].reshape(r1 - r0, hkv, g, d)
        s = torch.einsum("qhgd,khd->hgqk", qb, k[:r1]) * d ** -0.5
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        where = torch.arange(r1, device=q.device)[None, :] <= rows
        p = star_softmax(s, fmt[0], fmt[1], where=where)
        out[r0:r1] = torch.einsum("hgqk,khd->qhgd", p, v[:r1]).reshape(r1 - r0, hq, d)
    return out


def moe(x: torch.Tensor, p: Dict[str, torch.Tensor], model: dict, fmt, prompt_len: int,
        prec: Precision) -> torch.Tensor:
    e, top = model["num_experts"], model["top_k"]
    probs = star_softmax(prec.mm(x, p["router"]), fmt[0], fmt[1])
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top], idx[:, :top]
    total = vals[:, 0]
    for i in range(1, top):
        total = total + vals[:, i]
    gates = vals / torch.clamp(total, min=1e-9)[:, None]
    # the prompt's rows: one group, each (row, choice) queued in order
    cap = max(1, int(model["capacity_factor"] * top * prompt_len / e))
    onehot = torch.nn.functional.one_hot(idx[:prompt_len], e).reshape(-1, e)
    queue = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1).reshape(prompt_len, top)
    keep = torch.ones_like(gates, dtype=torch.bool)
    keep[:prompt_len] = queue < cap
    gates = gates * keep
    y = torch.zeros_like(x)
    for ex in range(e):
        rows, choice = torch.nonzero(idx == ex, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = prec.held(torch.nn.functional.silu(prec.mm(xe, p["wg"][ex]))
                       * prec.mm(xe, p["wi"][ex]))
        y.index_add_(0, rows, prec.mm(h, p["wo"][ex]) * gates[rows, choice][:, None])
    return prec.held(y)


def mlp(x: torch.Tensor, p: Dict[str, torch.Tensor], prec: Precision) -> torch.Tensor:
    h = prec.held(torch.nn.functional.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"]))
    return prec.mm(h, p["wo"])


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
