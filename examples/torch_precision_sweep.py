"""The paper's precision trade-off (§II, "softmax is precision-insensitive")
on the PyTorch / H100 port, as ``precision_sweep.py`` runs it for the JAX
package: train the induction-retrieval classifier with the exact softmax,
then swap its attention softmax for the STAR engine at 9 down to 2 bits and
print accuracy, the softmax's error and a calibration suggestion.

    PYTHONPATH=src python examples/torch_precision_sweep.py               # on the card
    PYTHONPATH=src python examples/torch_precision_sweep.py --device cpu  # plain versions

The classifier is its own copy of ``benchmarks/accuracy_bitwidth.py``'s
(D 64, 4 heads, 2 layers, vocab 32, 8 classes, T 32): the same data from
numpy, the same parameter draws (``hwmodel.prng``, ``jax.random``'s
generator), the same forward and Adam.  It trains on the exact plain route
(``impl="reference"``, torch autograd: the kernels have no gradient) and
evaluates every format through ``ops.attention(impl="pallas")``: on the card
flash_star's float32 kernel at head_dim 16, the block route at 2 to 5 bits;
on the CPU its plain version.  The softmax error column is
``ops.softmax(impl="pallas")`` (the STAR softmax kernel) on a fixed probe.
The last line lists the kernel launches of the sweep.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from repro_torch import ops
from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.core.precision import calibrate_format
from repro_torch.core.star_softmax import exact_softmax
from repro_torch.hwmodel import prng
from repro_torch.kernels import launch_counts, reset_launch_counts

D, H, LAYERS, VOCAB, CLASSES, SEQ = 64, 4, 2, 32, 8, 32

# (row label, format): the reference's sweep, exact first
FORMATS = [
    ("exact", None),
    ("9b (6i.3f)", FixedPointFormat(6, 3)),
    ("8b (6i.2f)", FixedPointFormat(6, 2)),
    ("7b (5i.2f)", FixedPointFormat(5, 2)),
    ("6b (5i.1f)", FixedPointFormat(5, 1)),
    ("5b (4i.1f)", FixedPointFormat(4, 1)),
    ("4b (3i.1f)", FixedPointFormat(3, 1)),
    ("3b (2i.1f)", FixedPointFormat(2, 1)),
    ("2b (1i.1f)", FixedPointFormat(1, 1)),
]


def gen_data(n: int, seed: int, device="cpu"):
    """Induction retrieval: toks[0] is a cue; it reappears once at a random
    position p; the label is toks[p + 1] % CLASSES.  The same numpy draws as
    the reference's, so the same tokens and labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(CLASSES, VOCAB, (n, SEQ)).astype(np.int32)  # filler
    cue = rng.integers(CLASSES, VOCAB, n)
    p = rng.integers(2, SEQ - 1, n)
    ans = rng.integers(0, CLASSES, n)
    rows = np.arange(n)
    toks[rows, 0] = cue
    toks[rows, p] = cue
    toks[rows, p + 1] = ans  # answer tokens live in [0, CLASSES)
    return (torch.as_tensor(toks, dtype=torch.int64, device=device),
            torch.as_tensor(ans, dtype=torch.int64, device=device))


def init_params(seed: int = 0, device="cpu") -> dict:
    """The reference's ``init_params(jax.random.PRNGKey(seed))`` draws."""
    ks = prng.split(prng.PRNGKey(seed), 3 + LAYERS)

    def normal(key, shape, scale):
        return prng.normal(key, shape, device) * scale

    p = {
        "emb": normal(ks[0], (VOCAB, D), 0.1),
        "pos": normal(ks[1], (SEQ, D), 0.1),
        "head": normal(ks[2], (D, CLASSES), 0.1),
        "layers": [],
    }
    for i in range(LAYERS):
        k1, k2, k3, k4, k5, k6 = prng.split(ks[3 + i], 6)
        p["layers"].append({
            "wq": normal(k1, (D, D), D ** -0.5),
            "wk": normal(k2, (D, D), D ** -0.5),
            "wv": normal(k3, (D, D), D ** -0.5),
            "wo": normal(k4, (D, D), D ** -0.5),
            "w1": normal(k5, (D, 2 * D), D ** -0.5),
            "w2": normal(k6, (2 * D, D), (2 * D) ** -0.5),
        })
    return p


def params_from_numpy(tree, device="cpu") -> dict:
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) as this module's float32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def _leaves(p):
    if isinstance(p, dict):
        return [x for v in p.values() for x in _leaves(v)]
    if isinstance(p, list):
        return [x for v in p for x in _leaves(v)]
    return [p]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _norm(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) / math.sqrt(D) + 1e-6)


def forward(p, toks, softmax: ops.SoftmaxSpec, impl: str = "reference"):
    """Class logits ``[n, CLASSES]``: bidirectional attention through
    ``ops.attention(impl=impl)``, classified from the cue position."""
    spec = ops.AttentionSpec(impl=impl, softmax=softmax)
    x = p["emb"][toks] + p["pos"][None]
    for lp in p["layers"]:
        xn = _norm(x)
        q = (xn @ lp["wq"]).reshape(*xn.shape[:2], H, D // H)
        k = (xn @ lp["wk"]).reshape(*xn.shape[:2], H, D // H)
        v = (xn @ lp["wv"]).reshape(*xn.shape[:2], H, D // H)
        a = ops.attention(q, k, v, spec)
        x = x + a.reshape(xn.shape) @ lp["wo"]
        # jax.nn.gelu's default: the tanh approximation
        x = x + torch.nn.functional.gelu(_norm(x) @ lp["w1"], approximate="tanh") @ lp["w2"]
    return x[:, 0] @ p["head"]


def loss_fn(p, toks, cls):
    logits = forward(p, toks, ops.SoftmaxSpec(kind="exact"))
    return -torch.log_softmax(logits, -1)[torch.arange(len(cls), device=cls.device), cls].mean()


def adam_step(p, mom, vel, toks, cls, t: int, lr: float = 2e-3):
    """One step of the reference's Adam (``accuracy_bitwidth.train``'s own
    formulas, no weight decay): returns ``(p, mom, vel, loss)``."""
    p = _map(lambda w: w.detach().requires_grad_(True), p)
    loss = loss_fn(p, toks, cls)
    grads = torch.autograd.grad(loss, _leaves(p))
    it = iter(grads)
    g = _map(lambda w: next(it), p)
    with torch.no_grad():
        tt = torch.tensor(float(t), dtype=torch.float32)
        c1 = float(1 - torch.tensor(0.9, dtype=torch.float32) ** tt)
        c2 = float(1 - torch.tensor(0.99, dtype=torch.float32) ** tt)
        mom = _map(lambda m, gw: 0.9 * m + 0.1 * gw, mom, g)
        vel = _map(lambda v, gw: 0.99 * v + 0.01 * gw * gw, vel, g)
        p = _map(lambda w, m, v: w - lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8), p, mom, vel)
    return p, mom, vel, float(loss.detach())


def train(steps: int = 300, lr: float = 2e-3, seed: int = 0, device="cpu"):
    """Exact-softmax training on batches of 128 (``gen_data`` seeds 1000 +
    step), as the reference's ``train``."""
    p = init_params(seed, device)
    mom = _map(torch.zeros_like, p)
    vel = _map(torch.zeros_like, p)
    loss = float("nan")
    for s in range(steps):
        toks, cls = gen_data(128, 1000 + s, device)
        p, mom, vel, loss = adam_step(p, mom, vel, toks, cls, s + 1, lr)
    return p, loss


@torch.no_grad()
def evaluate(p, softmax: ops.SoftmaxSpec, impl: str = "pallas", seed: int = 9) -> float:
    toks, cls = gen_data(1024, seed, p["emb"].device)
    pred = forward(p, toks, softmax, impl).argmax(-1)
    return float((pred == cls).float().mean())


def spec_of(fmt) -> ops.SoftmaxSpec:
    return (ops.SoftmaxSpec(kind="exact") if fmt is None
            else ops.SoftmaxSpec(kind="star", precision=fmt))


def probe(device="cpu") -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.normal(size=(64, 128)) * 5, dtype=torch.float32, device=device)


def sweep(p, device="cpu"):
    """``[(label, fmt, accuracy, softmax error)]`` over ``FORMATS``."""
    x = probe(device)
    exact = exact_softmax(x)
    rows = []
    for name, fmt in FORMATS:
        acc = evaluate(p, spec_of(fmt))
        err = 0.0
        if fmt is not None:
            got = ops.softmax(x, ops.SoftmaxSpec(kind="star", precision=fmt, impl="pallas"))
            err = float((got - exact).abs().max())
        rows.append((name, fmt, acc, err))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default: the card) or cpu")
    ap.add_argument("--steps", type=int, default=300, help="training steps")
    args = ap.parse_args(argv)
    dev = ops.resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host'})")
    print("training the induction-retrieval classifier (exact softmax)...")
    p, loss = train(steps=args.steps, device=dev)
    print(f"final loss {loss:.4f} after {args.steps} steps")

    reset_launch_counts()
    rows = sweep(p, dev)
    counts = {k: v for k, v in launch_counts().items() if v}
    print(f"{'format':>12s} {'accuracy':>9s} {'softmax err':>12s}")
    for name, _, acc, err in rows:
        print(f"{name:>12s} {acc*100:8.1f}% {err:12.4f}")

    # calibration on observed logits (the paper's per-dataset procedure)
    x = probe()
    z = x - x.max(dim=-1, keepdim=True).values
    fmt = calibrate_format(z.numpy())
    print(f"\ncalibrate_format on these logits -> {fmt.short_name()} "
          f"(paper's CNEWS/MRPC/CoLA formats were derived this way)")
    print("launches: " + json.dumps(counts, sort_keys=True))
    return rows


if __name__ == "__main__":
    main()
