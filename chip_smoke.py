#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch / H100 port runs.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. header: the card's name and power limit, torch / CUDA / Triton versions;
2. build: one ``nvcc`` per CUDA source, all started together, into build/;
3. parity at main-path shapes: each kernel against its plain PyTorch
   version on the same inputs on the card, bfloat16 and float32, with the
   tolerances below; kernel, plain and library times (CUDA events, median
   of 20 launches, warm L2);
4. small-input reference: the granite-8b smoke config served greedy on the
   card (kernels) and on the CPU (plain versions) with the same weights
   must give the same tokens;
5. serve: granite-8b at its published widths and all 36 layers, random
   weights drawn on the card from a seed, the continuous-batching engine
   over the paged KV cache (block size 16), 8 requests on 4 slots, prompts
   of 128-512 tokens, 16-32 new tokens each, temperature 0.8, with the
   attention (flash_star), paged decode and STAR sampling softmax kernels.
   Launch counters are zeroed just before and read just after; each kernel
   must have launched.  Then one full-width prefill through the kernels is
   held against the same prefill through the plain ``reference`` impls,
   and one decode tick is traced with ``torch.profiler`` (device time by
   kernel group);
6. the ``{"kernels": [...]}`` line and, last, the device line.

Tolerances.  float32 outputs: |kernel - plain| <= 5e-5 + 1e-4 |plain|;
bfloat16 outputs: <= 1e-2 + 8e-3 |plain| (two bf16 ulps: both round one
float32 value after summing in different orders).  Under STAR a score
within float32 summation error of a grid half-step may snap to the
neighbouring level in one of the two; a row outside tolerance passes only
if it holds such an ambiguous score (within 1e-3 grid units of a half-step,
from a float64 recomputation), and such rows must stay below 1e-4 of the
live scores.  The star softmax snaps its input itself, so its indices are
identical and it holds to 1e-5 |plain| + 1e-9.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
H100_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
H100_BF16_FLOPS = 989e12
H100_FP32_FLOPS = 67e12
FLIP_DELTA = 1e-3  # grid units
FLIP_BOUND = 1e-4  # flipped rows per live score


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers


def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tolerance(dtype):
    import torch

    if dtype == torch.bfloat16:
        return 1e-2, 8e-3
    return 5e-5, 1e-4


def compare_rows(name, got, ref, dtype, scores64=None, live=None, scale=None):
    """Hold ``got`` to ``ref`` row by row (last axis = features).  Returns
    (max abs error outside flipped rows, flipped rows)."""
    atol, rtol = tolerance(dtype)
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    bad_rows = (err > atol + rtol * r.abs()).any(dim=-1)
    n_bad = int(bad_rows.sum())
    if n_bad:
        check(scores64 is not None, f"{name}: {n_bad} rows out of tolerance (max err "
              f"{float(err.max()):.3e}) with no grid to explain them")
        grid = scores64 * scale
        amb = ((grid - grid.floor() - 0.5).abs() < FLIP_DELTA) & live
        unexplained = bad_rows & ~amb.any(dim=-1)
        check(not bool(unexplained.any()),
              f"{name}: {int(unexplained.sum())} rows out of tolerance hold no score "
              f"near a grid half-step (max err {float(err.max()):.3e})")
        n_live = int(live.sum())
        check(n_bad <= FLIP_BOUND * n_live,
              f"{name}: {n_bad} flipped rows exceed {FLIP_BOUND} of {n_live} live scores")
    max_err = float(err[~bad_rows].max()) if bool((~bad_rows).any()) else 0.0
    return max_err, n_bad


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version


def parity_flash(results):
    import torch
    import torch.nn.functional as F

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.flash_star import kernel as fk

    b, hq, hkv, t, d = 1, 32, 8, 512, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    info = torch.tensor([0, t], dtype=torch.int32, device=dev)
    sm_scale = d ** -0.5
    rows = torch.arange(t, device=dev)
    live = (rows[None, :] <= rows[:, None])[None, None].expand(b, hq, t, t)
    n_live = int(live[0, 0].sum()) * hq * b

    def sdpa(q, k, v):
        try:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        except TypeError:  # torch without enable_gqa: one call on repeated heads
            g = hq // hkv
            return F.scaled_dot_product_attention(
                q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), is_causal=True)

    variants = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dtype) for x in base)
        kr = k.double().repeat_interleave(hq // hkv, dim=1)
        scores64 = (q.double() @ kr.transpose(-1, -2)) * sm_scale
        for fmt in (FMT, None):
            mode = "star" if fmt is not None else "exact"
            kw = dict(fmt=fmt, causal=True)
            got = fk.flash_star_attention(q, k, v, info, **kw)
            ref = fk.flash_star_ref(q, k, v, info, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), f"flash_star {mode} {dtype}: non-finite")
            err, flips = compare_rows(f"flash_star {mode} {dtype}", got, ref, dtype,
                                      scores64, live, fmt.scale if fmt else None)
            ms = time_ms(lambda: fk.flash_star_attention(q, k, v, info, **kw))
            plain_ms = time_ms(lambda: fk.flash_star_ref(q, k, v, info, **kw))
            lib_ms = None
            if fmt is None:  # SDPA computes the exact-softmax function
                lib_ms = time_ms(lambda: sdpa(q, k, v))
            variants.append(dict(dtype=str(dtype).split(".")[-1], mode=mode,
                                 max_abs_err=err, grid_flip_rows=flips, ms=ms,
                                 plain_ms=plain_ms, library_ms=lib_ms))
            log(f"flash_star {mode:5s} {dtype}: max_abs_err={err:.3e} grid_flip_rows={flips} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms}")
    elem = 2  # bf16, the main path's type
    bytes_moved = (2 * b * hq * t * d + 2 * b * hkv * t * d) * elem + info.numel() * 4
    flops = 2 * 2 * n_live * d  # QK^T and P.V over the live (causal) scores
    main = variants[0]
    results.append(_entry(
        "flash_star", "cuda", "src/repro_torch/kernels/flash_star/csrc/flash_star.cu",
        "src/repro/kernels/flash_star/kernel.py:216", main, bytes_moved, flops,
        H100_BF16_FLOPS, variants, shape=f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] causal"))


def parity_paged(results):
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ref import gather_pages

    s, hq, hkv, d, bs = 4, 32, 8, 128, 16
    lens = [0, 1, 17, 600]
    w = -(-max(lens) // bs)
    n = s * w + 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((s, hq, d), (n, bs, hkv, d), (n, bs, hkv, d))]
    tables = (torch.randperm(n - 1, device=dev, generator=gen)[: s * w] + 1)
    tables = tables.reshape(s, w).to(torch.int32).contiguous()
    valid = torch.tensor(lens, dtype=torch.int32, device=dev)
    cols = torch.arange(w * bs, device=dev)
    live = (cols[None, :] < valid[:, None])[:, None, :].expand(s, hq, w * bs)
    variants = []
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp = (x.to(dtype) for x in base)
        kd, _ = gather_pages(kp, vp, tables)
        kd = kd.double().repeat_interleave(hq // hkv, dim=2)  # [S, W*bs, Hq, D]
        scores64 = torch.einsum("shd,sthd->sht", q.double(), kd) * d ** -0.5
        for fmt in (FMT, None):
            mode = "star" if fmt is not None else "exact"
            got = pk.paged_flash_attention(q, kp, vp, tables, valid, fmt=fmt)
            ref = pk.paged_attention_ref(q, kp, vp, tables, valid, fmt=fmt)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), f"paged {mode} {dtype}: non-finite")
            check(not bool(got[0].any()), f"paged {mode} {dtype}: free slot not zero")
            err, flips = compare_rows(f"paged {mode} {dtype}", got, ref, dtype,
                                      scores64, live, fmt.scale if fmt else None)
            ms = time_ms(lambda: pk.paged_flash_attention(q, kp, vp, tables, valid, fmt=fmt))
            plain_ms = time_ms(lambda: pk.paged_attention_ref(q, kp, vp, tables, valid, fmt=fmt))
            variants.append(dict(dtype=str(dtype).split(".")[-1], mode=mode,
                                 max_abs_err=err, grid_flip_rows=flips, ms=ms,
                                 plain_ms=plain_ms, library_ms=None))
            log(f"paged      {mode:5s} {dtype}: max_abs_err={err:.3e} grid_flip_rows={flips} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
    elem = 2
    live_rows = sum(lens)
    bytes_moved = (2 * live_rows * hkv * d + 2 * s * hq * d) * elem + (tables.numel() + s) * 4
    flops = 2 * 2 * live_rows * hq * d
    results.append(_entry(
        "paged_attention", "cuda",
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:222", variants[0], bytes_moved, flops,
        H100_BF16_FLOPS, variants, shape=f"S={s} bs={bs} lens={lens} Hq={hq} Hkv={hkv} D={d}"))


def parity_softmax(results):
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.star_softmax import kernel as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(4, 49152, device=dev, generator=gen) * 4
    got = sk.star_softmax_kernel(x, FMT)
    ref = sk.star_softmax_ref(x, FMT)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-9)),
          f"star_softmax: max err {err:.3e} out of tolerance")
    xi = x.clone()
    xi[:, :512] = -float("inf")  # saturates to the last level, never wraps
    gi = sk.star_softmax_kernel(xi, FMT)
    check(bool(torch.allclose(gi, sk.star_softmax_ref(xi, FMT), rtol=1e-5, atol=1e-9)),
          "star_softmax: -inf columns disagree with the plain version")
    ms = time_ms(lambda: sk.star_softmax_kernel(x, FMT))
    plain_ms = time_ms(lambda: sk.star_softmax_ref(x, FMT))
    log(f"star_softmax [4, 49152] f32: max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    variant = dict(dtype="float32", mode="gather", max_abs_err=err, grid_flip_rows=0,
                   ms=ms, plain_ms=plain_ms, library_ms=None)
    bytes_moved = 2 * x.numel() * 4
    ops = 16 * x.numel()  # per element: grid snap ~12, index 2, sum 1, divide 1
    results.append(_entry(
        "star_softmax", "triton", "src/repro_torch/kernels/star_softmax/triton_kernel.py",
        "src/repro/kernels/star_softmax/kernel.py:177", variant, bytes_moved,
        ops, H100_FP32_FLOPS, [variant], shape="[4, 49152] f32"))


def _entry(name, route, source, replaces, main, bytes_moved, ops, peak, variants, shape):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": main["library_ms"], "shape": shape, "variants": variants,
    }


# ---------------------------------------------------------------------------
# phase 4: small-input reference (card kernels vs CPU plain versions)


def small_reference():
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
    params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
    import numpy as np

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 11, 8, 3, 19)]
    gens = [4, 2, 5, 3, 6]
    outs = {}
    with ops.use(softmax="pallas"):
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            eng = ContinuousBatchingEngine(
                cfg, params, ContinuousConfig(num_slots=2, max_len=40, kv_block_size=4),
                device=dev)
            outs[dev] = eng.serve(prompts, gens)
    check(outs["cuda"] == outs["cpu"],
          f"smoke greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    log(f"small reference: greedy smoke tokens identical on card and cpu "
        f"({sum(gens)} tokens, 5 requests)")


# ---------------------------------------------------------------------------
# phase 5: serve granite-8b at full width and depth


def serve(results):
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import count_params, materialize
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_config("granite_8b"), attn_impl="pallas")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    torch.cuda.synchronize()
    log(f"serve: granite-8b {cfg.num_layers}L d={cfg.d_model} {count_params(model.param_specs()) / 1e9:.2f}B "
        f"params ({cfg.param_dtype}, compute {cfg.compute_dtype}) drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in rng.integers(128, 513, 8)]
    gens = [int(g) for g in rng.integers(16, 33, 8)]
    cb = ContinuousConfig(num_slots=4, max_len=512 + 32, temperature=0.8, kv_block_size=16)
    with ops.use(softmax="pallas"):
        eng = ContinuousBatchingEngine(cfg, params, cb, device="cuda", seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.serve(prompts, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    toks = [t for seq in out for t in seq]
    check([len(s) for s in out] == gens, f"serve: generated lengths {[len(s) for s in out]} != {gens}")
    check(all(0 <= t < cfg.vocab_size for t in toks), "serve: a token outside the vocabulary")
    ttft = eng.metrics.histogram("serve.ttft_s")
    peak = torch.cuda.max_memory_allocated()
    log(f"serve: {len(prompts)} requests, prompts {[len(p) for p in prompts]}, "
        f"{len(toks)} tokens in {wall:.3f}s = {len(toks) / wall:.2f} tok/s, "
        f"{eng.ticks} decode ticks, ttft p50={1e3 * ttft.percentile(50):.1f}ms, "
        f"max_memory_allocated={peak / 2**30:.2f} GiB")
    log(f"serve: launches {counts}")
    need = {"flash_star": cfg.num_layers * len(prompts),
            "paged_attention": cfg.num_layers * eng.ticks,
            "star_softmax": eng.ticks}
    for name, least in need.items():
        check(counts.get(name, 0) >= least,
              f"serve: {name} launched {counts.get(name, 0)} times, expected >= {least}")
    for entry in results:
        entry["launches"] = counts[entry["name"]]

    # one full-width prefill through the kernels vs the plain reference impls
    tokens = torch.as_tensor(prompts[0][:128], device="cuda")[None]
    with torch.no_grad():
        got, _ = model.prefill(params, tokens, 128)
        with ops.use(attention="reference"):
            ref, _ = model.prefill(params, tokens, 128)
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "full-width prefill: non-finite logits")
    rel = float((got - ref).norm() / ref.norm())
    log(f"full-width prefill logits, kernels vs reference impls: rel_l2={rel:.3e} "
        f"max_abs={float((got - ref).abs().max()):.3e}")
    check(rel < 3e-2, f"full-width prefill logits differ from the reference: rel_l2={rel:.3e}")
    profile_tick(cfg, params)
    return {"tokens": len(toks), "wall_s": wall, "tok_per_s": len(toks) / wall,
            "ticks": eng.ticks, "ttft_p50_s": ttft.percentile(50),
            "max_memory_allocated": peak}


def profile_tick(cfg, params) -> None:
    """Device time of one full-width decode tick (4 active slots) by kernel
    group, from ``torch.profiler``; where the profiler records no device
    time the breakdown is reported as not measured."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import ops
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cb = ContinuousConfig(num_slots=4, max_len=512 + 32, temperature=0.8, kv_block_size=16)
    eng = ContinuousBatchingEngine(cfg, params, cb, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    for n in (512, 384, 256, 128):
        eng.submit(rng.integers(0, cfg.vocab_size, (n,)), 4)
    with ops.use(softmax="pallas"):
        eng.step()  # admissions and the first tick, outside the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        name = ev.key.lower()
        if "paged_kernel" in name:
            group = "paged_attention"
        elif "star_softmax_rows" in name:
            group = "star_softmax"
        elif any(g in name for g in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
            group = "gemm"
        elif "copy" in name or "cast" in name or "convert" in name:
            group = "copy/cast"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + us
    busy = sum(groups.values())
    if busy <= 0:
        log("profile: the profiler recorded no device time (breakdown not measured)")
        return
    shares = {g: round(us / busy, 4) for g, us in sorted(groups.items(), key=lambda x: -x[1])}
    log(f"profile: one decode tick, 4 slots: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%} of wall); device time by group "
        f"(ms): { {g: round(us / 1e3, 3) for g, us in groups.items()} }; shares {shares}")


# ---------------------------------------------------------------------------


def main() -> int:
    src = ROOT / "src" / "repro_torch"
    if not src.is_dir():
        print(f"chip_smoke: {src} not found: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    import triton

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"triton {triton.__version__} device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_star import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk

    t0 = time.perf_counter()
    logs = _cuda.build([fk.SOURCE, pk.SOURCE])
    log(f"build: {time.perf_counter() - t0:.1f}s (nvcc, both sources at once)")
    for path, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {path.name}: {line.strip()}")

    results = []
    parity_flash(results)
    parity_paged(results)
    parity_softmax(results)
    small_reference()
    summary = serve(results)
    for entry in results:
        check(entry["launches"] > 0, f"{entry['name']} never launched on the main path")
    log(json.dumps({"serve": summary, "card": card}))
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(3)
