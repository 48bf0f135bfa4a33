"""Serving launcher of the port: the lockstep engine (the default, as the
reference's: one batch prefilled and decoded together, every family), or
continuous batching (attention models; the ssm, hybrid and encdec families
are refused, as the reference refuses them) over the dense per-slot KV pool
(the default layout) or the paged block pool.

  # granite-8b on the lockstep engine, on the card: flash_star prefill and
  # decode (Tq = 1 over the scalar-len cache), the STAR sampling softmax
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \\
      --attn-impl pallas --softmax-impl pallas --temperature 0.8

  # continuous batching over the dense pool: flash_star decode at Tq = 1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \\
      --engine continuous --attn-impl pallas --softmax-impl pallas

  # the paged pool: flash_star prefill, the paged decode kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b \\
      --engine continuous --kv-layout paged --attn-impl pallas --softmax-impl pallas

  # smoke config on the CPU (the kernels' plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b --smoke \\
      --device cpu --engine continuous --attn-impl pallas --softmax-impl pallas

  # quantized pages, shared-prefix cache, chunked prefill (paged only)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b --smoke \\
      --device cpu --engine continuous --kv-layout paged --attn-impl pallas \\
      --kv-dtype int8 --prefix-cache --prefill-chunk-tokens 8

  # mamba2-130m on the lockstep engine: the SSD chunk-scan kernel in every
  # layer of the prefill, the STAR sampling softmax at every step
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \\
      --batch 8 --prompt-len 2048 --gen 32 --softmax-impl pallas

  # qwen2-vl-7b: every request brings stub patch embeddings (num_patches x
  # frontend_dim, seeded), prepended with M-RoPE positions
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_vl_7b \\
      --engine continuous --attn-impl pallas --softmax-impl pallas

  # recurrentgemma-2b (RG-LRU + local attention at head_dim 256) and
  # seamless-m4t-large-v2 (enc-dec: 64 stub frames of frontend_dim a row) on
  # the lockstep engine
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b \\
      --attn-impl pallas --softmax-impl pallas --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless_m4t_large_v2 \\
      --attn-impl pallas --softmax-impl pallas --prompt-len 256 --gen 32

``--attn-impl`` sets the config's attention impl, so prefill and decode
follow it (``pallas`` -> ``flash_star`` for prefill and dense decode,
``pallas_paged`` for paged decode); ``--attn-impl paged`` is the reference's
marker: dense invocations run ``xla`` and the continuous engine takes the
paged layout.  ``--softmax-impl`` retargets every softmax dispatch via
``ops.use``.  ``--kv-dtype`` int8 / fp8_e4m3 stores the page pool as codes
plus scale pages; ``--kv-pool-blocks`` bounds the pool (exhaustion
preempts).  Weights are random, drawn on the device from ``--seed``.  A
VLM arch's requests carry stub patch embeddings drawn from the same seeded
generator (the lockstep batch one ``[B, P, frontend_dim]`` tensor, each
continuous request its own ``[1, P, frontend_dim]``), an enc-dec arch's
batch ``[B, 64, frontend_dim]`` stub frames (as the reference's launcher
draws them), and ``--max-len`` defaults to ``prompt_len + gen + num_patches
+ 8``.

``--trace-out PATH`` enables tracing before the engine is built and writes
the run's Chrome trace-event JSON there (load it in https://ui.perfetto.dev);
``--metrics-out PATH`` writes ``{"engine": engine.stats(), "global": the
process registry's snapshot (dispatch and guard counters)}``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_8b --smoke \\
      --device cpu --engine continuous --trace-out build/trace.json \\
      --metrics-out build/metrics.json
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


SRC_FRAMES = 64  # an enc-dec request's stub frames, as the reference's launcher


def _frontend_kwargs(cfg, rng, batch):
    """A VLM's stub patch embeddings ``[batch, P, frontend_dim]`` or an
    enc-dec model's stub frames ``[batch, 64, frontend_dim]`` (float32, from
    ``rng``); no frontend for any other family."""
    if cfg.family == "vlm":
        return {"patch_embeds": rng.standard_normal(
            (batch, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"src_embeds": rng.standard_normal(
            (batch, SRC_FRAMES, cfg.frontend_dim or cfg.d_model)).astype(np.float32)}
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    ap.add_argument("--engine", choices=("lockstep", "continuous"), default="lockstep",
                    help="lockstep: one batch prefilled and decoded together (every family); "
                    "continuous: slot-pool batching (attention models)")
    ap.add_argument("--batch", type=int, default=4, help="lockstep: batch size")
    ap.add_argument("--requests", type=int, default=8, help="continuous: request count")
    ap.add_argument("--slots", type=int, default=4, help="continuous: KV slot pool size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--kv-layout", choices=("dense", "paged"), default="dense",
                    help="continuous-engine KV layout (--attn-impl paged also selects "
                    "'paged')")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-pool-blocks", type=int, default=None,
                    help="usable blocks in the pool (default: slots * ceil(max_len / "
                    "block size)); exhaustion preempts the latest-admitted request")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8", "fp8_e4m3"), default="fp32",
                    help="page-pool storage: int8/fp8_e4m3 codes + per-(block, head) "
                    "scales, dequantized inside the paged decode kernel")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV blocks of common prompt prefixes (radix trie)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="prompt tokens prefilled per tick, in power-of-two chunks "
                    "interleaved with decode")
    ap.add_argument("--attn-impl", default=None, metavar="IMPL",
                    help="attention impl of the config: reference|xla|pallas; 'paged' "
                    "also flips the continuous engine to the paged layout")
    ap.add_argument("--softmax-impl", default=None, metavar="IMPL",
                    help="force the softmax backend: reference|xla|pallas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing for the run and write Chrome trace-event JSON here")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot (engine stats + the global dispatch / "
                    "guard counters) as JSON")
    args = ap.parse_args(argv)

    from repro_torch import obs, ops

    if args.trace_out:
        obs.enable_tracing()  # engines bind the global tracer when they are built
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.param import materialize
    from repro_torch.models.registry import build_model

    device = ops.resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    ops.validate(cfg.attention_spec)
    if args.engine == "continuous":
        # fail at config time if the paged backend cannot read this layout
        ops.validate(cfg.paged_attention_spec, kv_dtype=args.kv_dtype)
    overrides = {"softmax": args.softmax_impl} if args.softmax_impl else {}
    with ops.use(**overrides):
        ops.validate(cfg.softmax_spec)
        params = materialize(build_model(cfg).param_specs(), args.seed, device)
        max_len = args.max_len or (args.prompt_len + args.gen + cfg.num_patches + 8)
        if args.engine == "lockstep":
            return run_lockstep(args, cfg, params, device, max_len)
        return run_continuous(args, cfg, params, device, max_len)


def run_continuous(args, cfg, params, device, max_len) -> int:
    """Serve ``args.requests`` mixed-length requests on the continuous
    engine and print its throughput and KV-pool summary."""
    import torch

    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    eng = ContinuousBatchingEngine(
        cfg, params,
        ContinuousConfig(num_slots=args.slots, max_len=max_len,
                         temperature=args.temperature, kv_layout=args.kv_layout,
                         kv_block_size=args.kv_block_size,
                         kv_pool_blocks=args.kv_pool_blocks,
                         kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
                         prefill_chunk_tokens=args.prefill_chunk_tokens),
        device=device, seed=args.seed,
    )
    rng = np.random.default_rng(args.seed)
    total = 0
    for _ in range(args.requests):
        plen = max(1, int(rng.integers(args.prompt_len // 2, args.prompt_len + 1)))
        gen = max(1, int(rng.integers(args.gen // 2, args.gen + 1)))
        prompt = rng.integers(0, cfg.vocab_size, (plen,))
        eng.submit(prompt, gen, **_frontend_kwargs(cfg, rng, 1))  # per-request patches
        total += gen
    t0 = time.perf_counter()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    st = eng.kv_stats()
    layout = (f"kv=paged bs={args.kv_block_size}" if st["layout"] == "paged"
              else "kv=dense")
    print(f"served {args.requests} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {device}) over {eng.ticks} decode ticks "
          f"({args.slots} slots, {layout})")
    if st["layout"] == "dense":
        print(f"dense kv: {st['kv_bytes_in_use'] / 1e6:.2f} MB pinned "
              f"({args.slots} slots x {eng.pool['layers']['k'].shape[2]} rows)")
    else:
        print(f"paged kv: kv_dtype={st['kv_dtype']}, peak {st['peak_used_blocks']}/"
              f"{st['total_blocks']} blocks ({st['peak_kv_bytes'] / 1e6:.2f} MB), "
              f"{st['preemptions']} preemptions")
    if st.get("prefix") is not None:
        p = st["prefix"]
        print(f"prefix cache: {p['hits']} hits, {p['tokens_saved']} prefill tokens saved, "
              f"{p['evicted']} evicted ({p['nodes']} trie nodes)")
    ttft = eng.metrics.histogram("serve.ttft_s")
    if ttft.count():
        print(f"ttft p50={1e3 * ttft.percentile(50):.1f}ms (n={ttft.count()})")
    bad = [t for toks in done.values() for t in toks if not 0 <= t < cfg.vocab_size]
    if bad:
        print(f"sampled {len(bad)} tokens outside the vocabulary: {bad[:8]}")
        return 1
    print("sample:", done[min(done)][:16])
    write_obs(args, eng)
    return 0


def run_lockstep(args, cfg, params, device, max_len) -> int:
    import torch

    from repro_torch import obs
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(cfg, params, ServeConfig(max_len=max_len, temperature=args.temperature),
                      device=device, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    kw = _frontend_kwargs(cfg, rng, args.batch)
    t0 = time.perf_counter()
    with obs.get_tracer().span("serve.generate", batch=args.batch, gen=args.gen):
        toks, info = eng.generate(prompts, args.gen, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s on {device}) cache_len={info['cache_len']}")
    out = toks.cpu().numpy()
    bad = out[(out < 0) | (out >= cfg.vocab_size)]
    if bad.size:
        print(f"sampled {bad.size} tokens outside the vocabulary: {bad[:8].tolist()}")
        return 1
    print("sample:", out[0][:16].tolist())
    write_obs(args)
    return 0


def write_obs(args, engine=None) -> None:
    """Write the Chrome trace and / or the metrics snapshot when asked."""
    import json

    from repro_torch import obs

    if args.trace_out:
        tracer = obs.get_tracer()
        tracer.export_chrome(args.trace_out)
        print(f"wrote {len(tracer.events)} trace events to {args.trace_out}")
    if args.metrics_out:
        snap = {"global": obs.default_registry().snapshot()}
        if engine is not None:
            snap["engine"] = engine.stats()
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, default=float)
        print(f"wrote metrics snapshot to {args.metrics_out}")


if __name__ == "__main__":
    sys.exit(main())
