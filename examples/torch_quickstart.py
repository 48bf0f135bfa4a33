"""Quickstart on the PyTorch / H100 port: the STAR softmax engine in four
acts, as ``quickstart.py`` shows them for the JAX package.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

1. drop-in quantized softmax (the paper's engine),
2. STAR attention (two-pass and vector-pipelined forms agree),
3. the flash_star kernel (CUDA on the card; its plain version on the CPU)
   matches both,
4. one dispatch layer (repro_torch.ops) swaps between all of them.

Prints "OK" last when every output is finite.
"""

import argparse

import numpy as np
import torch

from repro_torch import ops
from repro_torch.core.attention import EXACT_SOFTMAX, STAR_SOFTMAX, attention, blocked_attention
from repro_torch.core.fixedpoint import DEFAULT_FORMAT, FORMAT_MRPC
from repro_torch.core.star_softmax import exact_softmax, star_softmax
from repro_torch.kernels import launch_counts, reset_launch_counts


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)

    def tensor(shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    outputs = []
    # --- 1. the softmax engine -----------------------------------------------
    x = tensor((4, 128), 4.0)
    p_exact = exact_softmax(x)
    p_star = star_softmax(x, DEFAULT_FORMAT, mode="histogram")  # counter+VMM form
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'})")
    print("STAR softmax (8-bit CNEWS format)")
    print("  max |p_star - p_exact| =", err(p_star, p_exact))
    print("  rows sum to", p_star.sum(-1)[:2].tolist(), "...")
    p9 = star_softmax(x, FORMAT_MRPC)
    print("  9-bit error:", err(p9, p_exact), "(tighter)")
    outputs += [p_star, p9]

    # --- 2. STAR attention: two-pass vs vector-grained pipeline ---------------
    q = tensor((2, 64, 8, 32))
    k = tensor((2, 64, 2, 32))  # GQA 8:2
    v = tensor((2, 64, 2, 32))
    two_pass = attention(q, k, v, softmax=STAR_SOFTMAX, causal=True)
    pipelined = blocked_attention(q, k, v, softmax=STAR_SOFTMAX, causal=True, block_size=16)
    print("\nSTAR attention")
    print("  two-pass vs vector-pipeline:", err(two_pass, pipelined),
          "(integer-grid arithmetic makes the online form exact)")
    exact = attention(q, k, v, softmax=EXACT_SOFTMAX, causal=True)
    print("  STAR vs exact attention:   ", err(two_pass, exact))
    outputs += [two_pass, pipelined, exact]

    # --- 3. the fused flash_star kernel ---------------------------------------
    reset_launch_counts()
    flash = ops.AttentionSpec(impl="pallas", causal=True, block_q=32, block_k=32)
    kern = ops.attention(q, k, v, flash)
    kern8 = ops.attention(q, k, v, flash, pv_int8=True)
    route = "CUDA kernels" if dev.type == "cuda" else "their plain versions"
    launched = {name: n for name, n in launch_counts().items() if n}
    print(f"\nflash_star ({route}; launches {launched})")
    print("  kernel vs two-pass:", err(kern, two_pass))
    print("  int8 P*V variant err:", err(kern8, exact), "(beyond-paper: int8 tensor cores)")
    outputs += [kern, kern8]

    # --- 4. the dispatch layer ------------------------------------------------
    print("\nrepro_torch.ops registry")
    for backend in ops.backends("attention"):
        spec = ops.AttentionSpec(impl=backend.impl, causal=True, block_q=32, block_k=32,
                                 block_kv=32)
        out = ops.attention(q, k, v, spec)
        print(f"  attention[{backend.impl:9s}] vs two-pass: {err(out, two_pass):.2e}")
        outputs.append(out)
    p_policy = ops.softmax(x, ops.SoftmaxSpec(precision="auto:mrpc"))
    print("  named precision policy auto:mrpc ==", FORMAT_MRPC.short_name(),
          "err:", err(p_policy, p9))
    outputs.append(p_policy)
    assert all(bool(torch.isfinite(o).all()) for o in outputs), "non-finite output"
    print("\nOK")


if __name__ == "__main__":
    main()
