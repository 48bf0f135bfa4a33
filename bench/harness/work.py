"""The yardstick's arithmetic: the H100's peaks, and the operations and bytes
the served work needs, counted from the configuration and the lengths of
the traffic the harness generated, never from what a kernel does.

The counts are those of a decoder whose every layer is attention (holding
K/V) plus an MLP or a mixture of experts: the reference module of such
configurations re-exports them.  The readers take a configuration's counts
from the reference module it names (``run.arch``), never from here.

Peaks: one NVIDIA H100 SXM, dense rates (NVIDIA's data sheet): 989 TFLOP/s
in bf16 and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Iterable

PEAK_FLOPS = 989e12  # bf16 dense
HBM_BW = 3.35e12  # bytes/s


def _head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def layer_params(m: dict) -> int:
    """Parameters one token multiplies per layer: the attention projections,
    and the MLP or the router and ``top_k`` experts."""
    d, hd = m["d_model"], _head_dim(m)
    attn = d * hd * (2 * m["num_heads"] + 2 * m["num_kv_heads"])
    if m.get("num_experts"):
        ffn = d * m["num_experts"] + m["top_k"] * 3 * d * m["d_ff"]
    else:
        ffn = 3 * d * m["d_ff"]
    return attn + ffn


def attention_flops(m: dict, rows: int) -> int:
    """QK^T and P.V of one query over ``rows`` keys, all layers."""
    return 4 * m["num_heads"] * _head_dim(m) * rows * m["num_layers"]


def prefill_flops(m: dict, prompt: int) -> int:
    """A prompt of ``prompt`` tokens: every row through every layer, causal
    attention, and the logits of its last row."""
    mats = 2 * m["num_layers"] * layer_params(m) * prompt + 2 * m["d_model"] * m["vocab_size"]
    return mats + attention_flops(m, prompt * (prompt + 1) // 2)


def decode_flops(m: dict, rows: int) -> int:
    """One generated token whose query attends ``rows`` KV rows."""
    mats = 2 * (m["num_layers"] * layer_params(m) + m["d_model"] * m["vocab_size"])
    return mats + attention_flops(m, rows)


def paged_bytes(m: dict, rows: Iterable[int], elem: int = 2) -> int:
    """One decode tick's paged attention, all layers: each live K/V row read
    once, each query and output once (``rows``: the KV rows each active
    request attends)."""
    rows = list(rows)
    hd = _head_dim(m)
    kv = 2 * sum(rows) * m["num_kv_heads"] * hd * elem
    qo = 2 * len(rows) * m["num_heads"] * hd * elem
    return m["num_layers"] * (kv + qo)


def paged_least_s(m: dict, rows: Iterable[int], elem: int = 2) -> float:
    rows = list(rows)
    flops = attention_flops(m, sum(rows))
    return max(paged_bytes(m, rows, elem) / HBM_BW, flops / PEAK_FLOPS)


def flash_least_s(m: dict, prompt: int, elem: int = 2) -> float:
    """One prefill's attention, all layers: causal QK^T and P.V at the bf16
    peak, or Q, K, V and the output moved once, whichever is longer."""
    hd = _head_dim(m)
    flops = attention_flops(m, prompt * (prompt + 1) // 2)
    nbytes = m["num_layers"] * prompt * hd * (2 * m["num_heads"] + 2 * m["num_kv_heads"]) * elem
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)
