"""What every plain reference of the benchmark shares: the precisions it
computes in, and the blocks a decoder is built from.

A configuration file names its reference under ``"reference"``: a module
``bench/reference/<name>.py``, found by that name alone.  The module
provides

- ``logits(weights, model, fmt, tokens, prompt_len, out_rows, prec=FLOAT32,
  q_block=256) -> [len(out_rows), padded vocab]``, float32: the logits of
  one causal sequence ``tokens`` ``[N]`` (a prompt of ``prompt_len`` tokens,
  then generated ones) at the positions ``out_rows``, from the weights the
  benchmark drew in the port's layout, ``model`` the configuration's
  ``"model"`` section and ``fmt`` its STAR softmax format ``(int_bits,
  frac_bits)``; the columns past the vocabulary read :data:`MASKED_LOGIT`.
  ``prec`` is :data:`FLOAT32`, the reference, or :data:`FLOAT8`, the
  control, which every architecture takes from here; TF32 is off for the
  call (:func:`tf32_off`);
- the work the served tokens need, counted from ``model`` and the lengths
  alone: ``prefill_flops(model, prompt)``, ``decode_flops(model, rows)`` (one
  token whose query attends ``rows`` K/V rows), ``paged_least_s(model,
  rows)`` (one decode tick's paged attention, ``rows`` the K/V rows each
  active request attends) and ``flash_least_s(model, prompt)`` (one
  prefill's attention), the least seconds at the H100's peaks
  (``harness.work``).

A reference imports nothing of the program nor of the JAX package.

``prec`` says in what the model computes.  :data:`FLOAT32` is the
reference.  :data:`FLOAT8` is the control: the configuration's bfloat16
program with its products taken one precision lower, to float8 e4m3, the
step a faster program would take.  Both operands of every projection (the
weight, and the activation it multiplies) are rounded to float8 with one
scale per tensor, and the product accumulates in float32.  Every activation
the program holds in its compute dtype is rounded to bfloat16, as the
program holds it.  Attention's own products, the norms and the softmaxes run
in float32 on those values.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict

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
    """A top-k mixture of SwiGLU experts with a STAR router, GShard-style
    capacity: the prompt's rows are one group whose expert queues hold
    ``max(1, int(capacity_factor * top_k * rows / experts))`` choices in
    (row, choice) order, later choices dropped; each generated row is a group
    of its own, which drops nothing.  Gates are the top-k probabilities (ties
    to the lower expert) divided by their sum; a dropped choice weighs 0."""
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
    """A SwiGLU MLP."""
    h = prec.held(torch.nn.functional.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"]))
    return prec.mm(h, p["wo"])
