"""Continuous-batching serving on the PyTorch / H100 port: staggered
requests stream tokens live, as ``serve_star.py`` shows for the JAX package.

    PYTHONPATH=src python examples/torch_serve_star.py --arch granite_8b               # the card
    PYTHONPATH=src python examples/torch_serve_star.py --arch granite_8b --device cpu

A pool of KV-cache slots absorbs requests as they "arrive" (submitted
across ticks to mimic network arrival).  Every tick runs one decode across
the whole pool (a CUDA graph replay on the card); each slot decodes at its
own depth, so short and long requests coexist without padding or lockstep.
Tokens print as they are sampled: the streaming view a serving frontend
would forward.  Sampling runs through the STAR softmax engine (its CUDA
kernel on the card) when the config says so.  Smoke configs with random
weights from seed 0.
"""

import argparse

import numpy as np

from repro_torch import ops
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.param import materialize
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

ATTENTION_ARCHS = [a for a in ARCH_IDS if a not in
                   ("mamba2_130m", "recurrentgemma_2b", "seamless_m4t_large_v2")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite_8b", choices=ATTENTION_ARCHS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda", help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)

    dev = ops.resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = materialize(build_model(cfg).param_specs(), 0, dev)
    rng = np.random.default_rng(0)
    eng = ContinuousBatchingEngine(
        cfg, params,
        ContinuousConfig(num_slots=args.slots, max_len=64, temperature=args.temperature),
        device=dev)

    # Mixed-length requests with staggered arrivals: submit a couple per
    # tick while the engine is already decoding earlier ones.
    pending = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, 20))
        gen = int(rng.integers(4, 12))
        kw = {}
        if cfg.family == "vlm":
            kw["patch_embeds"] = rng.standard_normal(
                (1, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
        pending.append((rng.integers(0, cfg.vocab_size, (plen,)), gen, kw))

    fmt = cfg.softmax_spec.fmt
    print(f"{args.arch} [{cfg.family}] on {dev}: {args.requests} requests -> "
          f"{args.slots} slots  ({f'STAR {fmt.short_name()} codebook' if fmt else 'exact'})")
    streams = {}
    tick = 0
    while pending or not eng.scheduler.done():
        if pending and tick % 2 == 0:  # two new arrivals every other tick
            for prompt, gen, kw in pending[:2]:
                uid = eng.submit(prompt, gen, **kw)
                print(f"  [tick {tick}] arrive req{uid} "
                      f"(prompt {len(prompt)} toks, budget {gen})")
            pending = pending[2:]
        for ev in eng.step():
            streams.setdefault(ev.uid, []).append(ev.token)
            tail = " <done>" if ev.finished else ""
            print(f"    req{ev.uid} +tok[{ev.index}]={ev.token}{tail}")
        tick += 1

    print(f"\nall {len(streams)} requests served in {eng.ticks} decode ticks:")
    for uid in sorted(streams):
        print(f"  req{uid}: {streams[uid]}")


if __name__ == "__main__":
    main()
