#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch / H100 port runs.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. header: the card's name and power limit, torch / CUDA / Triton versions;
2. build: one ``nvcc`` per CUDA source, all started together, into build/
   (a library built earlier, by a test or an earlier run, is reused with
   the compiler log kept beside it); each kernel's registers and spills
   from ptxas; for flash_star's bf16 tensor-core kernel
   (``flash_star_mma_kernel``, 8 instantiations) 0 spill bytes and bf16
   HMMA instructions in its SASS (``cuobjdump -sass``); for the split-KV
   paged kernels (48 ``paged_split_kernel`` and 4 ``paged_combine_kernel``
   instantiations) 0 spill bytes;
3. parity at main-path shapes: each kernel against its plain PyTorch
   version on the same inputs on the card, bfloat16 and float32, with the
   tolerances below; kernel, plain and library times (CUDA events, median
   of 20 launches, warm L2: the host's time to enqueue a call included).
   flash_star also at the chunked-prefill append shape (a 128-row chunk at
   q_offset 256 over a 512-row staging cache with 384 valid rows), SDPA
   timed there for the exact variant with a boolean mask; each of its
   variants names the kernel that ran it (bf16: mma.sync, float32: FP32
   FMA) with its device time from ``torch.profiler`` (SDPA's too), the
   achieved TFLOP/s and its share of the bound; in bf16 it also counts the
   output elements that differ from the plain version at all.  Then the
   bf16 STAR kernel with its LUT in shared memory (the default format)
   against the same kernel reading a 13-bit format's LUT from global
   memory: the same outputs bit for bit, both device times.  The paged
   kernels (split-KV + combine) over bf16 / float32 pools and over int8 and
   fp8_e4m3 pools (codes and scales from ``kvquant.quantize_blocks``; the
   second entry, ``paged_attention_quant``), bf16 and float32 q, STAR and
   exact, at three shapes of S 4, Hq 32, Hkv 8, D 128, bs 16: the smoke
   shape (lens 0/1/17/600), the full-width decode tick's (lens
   514/386/258/130, W 34) and short contexts (lens 0/1/17/30, W 2: one
   split, no combine); each with its device time split into the split and
   the combine kernel, its bound (the live K/V bytes, or operations at the
   FP32 peak) and share of it; at the tick shape also slot 0 alone under
   its narrowest table bit-equal to slot 0 in the batch, and at the short
   shape each slot (one split: the split kernel writes the output itself)
   bit-equal to the same slot in a batch under the tick's table width (9
   splits, through the combine).  The STAR softmax: the Triton kernel in
   ``gather`` mode, ``onehot`` bit-equal to it, and the CUDA LUT kernel
   (``star_softmax_lut``) in clean ``histogram`` mode and under the mild
   fault in every mode, at the sampling shape [4, 49152]; the fault
   realization's bits on the card equal the CPU's.  flash_star's int8 P.V
   variant (``flash_star_pv_int8``) at the granite prefill shape and ragged
   (Tk 500, kv_valid 450), block_k 128; the SSD chunk scan (``ssd_scan``) at
   the Mamba2 serve's prefill shape (xdt [8, 2048, 24, 64], B/C [8, 2048,
   128] as slices of one conv output, bf16 and float32, chunk 128) and at a
   ragged T = 2000;
4. small-input reference: the granite-8b smoke config served greedy on the
   card (kernels) and on the CPU (plain versions) with the same weights
   must give the same tokens: once over an fp32 pool, then over int8 and
   fp8_e4m3 pools with the prefix cache, 8-token prefill chunks, prompts
   sharing a prefix and a pool small enough to force a preemption, then
   under the mild fault (histogram mode, faulty attention on the
   materialized ``reference`` path).  Then the smoke config at temperature
   0.8 on the card in clean ``onehot`` and ``histogram`` mode: that mode's
   softmax kernel launches for every sampled batch, and the probabilities of
   the first request's first sample equal the CPU plain version's.  Then the
   mamba2-130m smoke config on the lockstep engine, greedy, card == CPU;
5. serve: granite-8b at its published widths and all 36 layers, random
   weights drawn on the card from a seed, the continuous-batching engine
   over the paged KV cache (block size 16), 8 requests on 4 slots, prompts
   of 128-512 tokens, 16-32 new tokens each, temperature 0.8, with the
   attention (flash_star), paged decode and STAR sampling softmax kernels.
   Launch counters are zeroed just before and read just after; each kernel
   must have launched, the paged kernel once per layer of every tick.  Then one full-width prefill through the kernels is
   held against the same prefill through the plain ``reference`` impls,
   and the longest prompt's prefill and one decode tick are traced with
   ``torch.profiler`` (device time by kernel group).  Then the int8 P.V
   path: one full-width prefill whose attention spec sets ``pv_int8``
   (counters zeroed just before: the variant launches once per layer),
   held against the float P.V prefill;
6. quantized serve: the same weights over an int8 page pool with the
   prefix cache and 128-token prefill chunks, 8 requests of a common
   256-token system prefix plus their own 64-256-token suffix, 16-32 new
   tokens, temperature 0.8, on a pool sized to force preemption.  Counters
   zeroed just before and read just after: the quantized paged kernel must
   launch for every layer of every tick and flash_star for every layer of
   every chunk; prefix hits and preemptions must both occur.  Then one
   full-width decode step over the int8 pool through the kernel is held
   against the same step through the ``reference`` paged impl, and one
   int8 decode tick and one 128-token prefill chunk are traced;
7. degraded-RRAM serve: the same weights with a seeded ``FaultModel`` in
   the config's softmax spec (attention ``xla``, so faulty rows take the
   materialized ``reference`` path; sampling softmax ``pallas``), 4 requests
   on 4 slots, prompts of 128-256 tokens, 16 new tokens, temperature 0.8,
   under the accuracy guard.  7a: the mild fault in ``histogram`` mode with
   a non-latching guard: the LUT kernel launches for every sampled batch and
   the guard checks every one.  7b: a severe fault in ``gather`` mode with
   a latching guard: it trips, falls back and latches; the kernel
   ran before the trip and not after (its budget: twice the clean engine's
   error on the same traffic, logged).  Then ``ops.matmul(impl="hwmodel")``
   at granite-8b's q and MLP-up projection widths (layer 0's weights) under
   a guard, clean and under the mild fault (the crossbar kernel must
   launch), and the crossbar kernel against its plain version at those
   shapes (clean bit-exact; faulty equal but for ADC codes within 1e-3 LSB
   of a half-step, at most 1e-4 of the outputs);
8. Mamba2 serve: mamba2-130m at its published widths and all 24 layers,
   random weights drawn on the card from a seed, on the lockstep engine:
   8 prompts of 2048 tokens, 32 new tokens, temperature 0.8, sampling
   softmax ``pallas``.  Counters zeroed just before and read just after:
   ``ssd_scan`` once per layer of the prefill, the STAR softmax once per
   sampled step.  Tok/s, time to first token (a prefill and its sample,
   timed alone), the time of a decode step and peak memory.  One
   full-width prefill through the kernel is held against the same prefill
   under ``ops.use(ssd_scan="reference")``, in bf16 and in float32 compute,
   and one prefill and one decode step are traced;
9. the ``{"kernels": [...]}`` line and, last, the device line.

Tolerances.  float32 outputs: |kernel - plain| <= 5e-5 + 1e-4 |plain|;
bfloat16 outputs: <= 1e-2 + 8e-3 |plain| (two bf16 ulps: both round one
float32 value after summing in different orders).  Under STAR a score
within float32 summation error of a grid half-step may snap to the
neighbouring level in one of the two; a row outside tolerance passes only
if it holds such an ambiguous score (within 1e-3 grid units of a half-step,
from a float64 recomputation), and such rows must stay below 1e-4 of the
live scores.  flash_star's bf16 output also differs from the plain
version's in at most BF16_DIFF_BOUND of its elements: P.V on three bf16
pieces of P only reorders float32 sums, which moves a bf16 rounding in
about 0.02 % of them, where a kernel that rounds P to bf16 once moves
about a third.  The int8 P.V variant holds to the same tolerances, a row
outside them passing only if it holds an ambiguous code: a score near a grid
half-step (STAR) or a p near a half-step of 1/127 (exact), counted and
bounded the same way.  ssd_scan: y and the final state within SSD_RTOL of
their largest magnitude (float32 sums in another order).  The star softmax
kernels snap their input themselves, so
their indices are identical and they hold to 1e-5 |plain| + 1e-9 (the LUT
kernel's faulty histogram divides by the ADC gain after the row, the plain
version before: an ulp).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
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
H100_INT8_OPS = 1979e12
FLIP_DELTA = 1e-3  # grid units (and ADC LSBs)
FLIP_BOUND = 1e-4  # flipped rows per live score (and ADC flips per output)
BF16_DIFF_BOUND = 1e-2  # flash_star bf16: output elements unequal to the plain version's
FLASH_DESIGNS = {"bfloat16": "mma.sync bf16, P in three bf16 pieces", "float32": "fp32 FMA"}
SSD_RTOL = 1e-5  # ssd_scan: max |kernel - plain| per max |plain| (float32 sums reordered)
MILD = dict(g_sigma=0.05, stuck_on_rate=0.01, stuck_off_rate=0.01,
            adc_offset_sigma=0.1, read_disturb=0.01, seed=7)
SEVERE = dict(stuck_on_rate=0.6, stuck_off_rate=0.2, seed=3)


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


def device_ms(fn, reps: int = 20):
    """Device time of one call of ``fn``: the self time of every kernel it
    launches, from ``torch.profiler``, averaged over ``reps`` calls.  Unlike
    ``time_ms`` it leaves out the host's time to enqueue the call.  None
    where the profiler records no device time."""
    by_kernel = device_ms_by_kernel(fn, reps)
    return sum(by_kernel.values()) if by_kernel else None


def device_ms_by_kernel(fn, reps: int = 20):
    """``device_ms`` by kernel name: {name: ms per call}, empty where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = _self_device_us(ev) if ev.device_type == torch.autograd.DeviceType.CUDA else 0
        if us > 0:
            out[ev.key] = out.get(ev.key, 0.0) + us / reps / 1e3
    return out


def _self_device_us(ev) -> float:
    us = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if us is None else us


def tolerance(dtype):
    import torch

    if dtype == torch.bfloat16:
        return 1e-2, 8e-3
    return 5e-5, 1e-4


def near_half_step(x):
    """Entries of a float64 tensor within FLIP_DELTA of a rounding half-step."""
    return (x - x.floor() - 0.5).abs() < FLIP_DELTA


def compare_rows(name, got, ref, dtype, scores64=None, live=None, scale=None, amb=None):
    """Hold ``got`` to ``ref`` row by row (last axis = features).  A row out
    of tolerance must hold an ambiguous live entry: ``amb`` when given, else a
    score near a grid half-step.  Returns (max abs error outside flipped
    rows, flipped rows)."""
    atol, rtol = tolerance(dtype)
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    bad_rows = (err > atol + rtol * r.abs()).any(dim=-1)
    n_bad = int(bad_rows.sum())
    if n_bad:
        check(amb is not None or scores64 is not None,
              f"{name}: {n_bad} rows out of tolerance (max err "
              f"{float(err.max()):.3e}) with no grid to explain them")
        if amb is None:
            amb = near_half_step(scores64 * scale) & live
        else:
            amb = amb & live
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
# phase 2: what the compiler made of the bf16 flash_star kernel


def ptxas_by_function(text):
    """``nvcc -Xptxas -v`` output as {kernel: [registers line, spill line]}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, [])
        elif cur and ("spill" in line or "Used" in line):
            out[cur].append(line.replace("ptxas info    :", "").strip())
    return out


def _cuobjdump():
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(found):
        return found
    import triton

    found = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    check(found.exists(), "cuobjdump not found (CUDA toolkit or Triton's copy)")
    return str(found)


def check_mma_build(ptxas_log, library):
    """The bf16 flash_star kernel runs on the tensor cores and spills
    nothing: each instantiation's ptxas line (0 spill bytes) and its count
    of HMMA instructions in the SASS of the built library."""
    mma = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
           if "flash_star_mma_kernel" in f}
    check(len(mma) == 8, f"expected 8 flash_star_mma_kernel instantiations, ptxas shows {len(mma)}")
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    hmma, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
        elif cur and "HMMA" in line:
            hmma.setdefault(cur, []).append(line.split("HMMA")[1].split()[0])
    for func, lines in sorted(mma.items()):
        m = re.search(r"ILi(\d+)ELb([01])E", func)
        tag = f"D={m.group(1)} {'star' if m.group(2) == '1' else 'exact'}" if m else func
        ops = hmma.get(func, [])
        kinds = sorted(set(ops))
        log(f"flash_star_mma_kernel {tag}: ptxas {'; '.join(lines)}; SASS HMMA x {len(ops)} {kinds}")
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"flash_star_mma_kernel {tag} spills: {lines}")
        check(any(".BF16" in k for k in kinds), f"flash_star_mma_kernel {tag}: no bf16 HMMA in its SASS")


def check_paged_build(ptxas_log):
    """Every instantiation of the paged split kernel (2 q types x 3 pool
    types for the fp entry and the two code types, 4 head dims, STAR and
    exact: 48) and of its combine (4) spills nothing."""
    funcs = {f: lines for f, lines in ptxas_by_function(ptxas_log).items()
             if "paged_split_kernel" in f or "paged_combine_kernel" in f}
    n_split = sum("paged_split_kernel" in f for f in funcs)
    check(n_split == 48 and len(funcs) == 52,
          f"expected 48 paged_split_kernel and 4 paged_combine_kernel instantiations, "
          f"ptxas shows {n_split} and {len(funcs) - n_split}")
    for func, lines in sorted(funcs.items()):
        check(any("0 bytes spill stores, 0 bytes spill loads" in x for x in lines),
              f"paged kernel {func} spills: {lines}")
    log(f"paged kernels: {len(funcs)} instantiations, 0 spill bytes in each")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version


def _flash_variants(label, base, info, live, sdpa=None, shape=None, pv_int8_block=None):
    """flash_star against its plain version on ``base`` (q, k, v float32)
    in bf16 and f32, STAR and exact; ``sdpa`` times the library call for
    the exact variant.  With ``pv_int8_block`` the int8 P.V variant over
    KV blocks of that many rows, whose flips are counted as ambiguous codes
    (``_pv_int8_ambiguous``).  Without it each variant also records the
    kernel it ran (``design``), its device time from the profiler, and the
    achieved TFLOP/s and share of its bound at that time: operations 4 x
    live scores x D (QK^T and P.V) at the peak of the input type (bf16
    tensor cores, FP32 for float32), bytes q + out + the K/V rows some row
    sees, at 3.35 TB/s."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.flash_star import kernel as fk

    b, hq, hkv, d = base[0].shape[0], base[0].shape[1], base[1].shape[1], base[0].shape[3]
    n_live = int(live.sum())
    kv_rows = int(live.reshape(-1, live.shape[-1]).any(dim=0).sum())
    flips_key = "grid_flip_rows" if pv_int8_block is None else "code_flip_rows"
    variants = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (x.to(dtype) for x in base)
        kr = k.double().repeat_interleave(hq // hkv, dim=1)
        scores64 = (q.double() @ kr.transpose(-1, -2)) * d ** -0.5
        for fmt in (FMT, None):
            mode = "star" if fmt is not None else "exact"
            name = f"{label} {mode} {dtype}"
            kw = dict(fmt=fmt, causal=True)
            amb = None
            if pv_int8_block is not None:
                kw.update(block_k=pv_int8_block, pv_int8=True)
                amb = _pv_int8_ambiguous(scores64, live, pv_int8_block, fmt)
            got = fk.flash_star_attention(q, k, v, info, **kw)
            ref = fk.flash_star_ref(q, k, v, info, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
            n_diff = None
            if dtype == torch.bfloat16 and pv_int8_block is None:
                n_diff = int((got != ref).sum())
                log(f"{name}: {n_diff} of {got.numel()} bf16 output elements differ "
                    f"from the plain version (at most {BF16_DIFF_BOUND:g} of them may)")
            err, flips = compare_rows(name, got, ref, dtype, scores64, live,
                                      fmt.scale if fmt else None, amb=amb)
            if n_diff is not None:
                check(n_diff <= BF16_DIFF_BOUND * got.numel(),
                      f"{name}: {n_diff} of {got.numel()} bf16 output elements differ from "
                      f"the plain version, over {BF16_DIFF_BOUND:g} of them: is P rounded "
                      f"to bf16 before P.V?")
            ms = time_ms(lambda: fk.flash_star_attention(q, k, v, info, **kw))
            plain_ms = time_ms(lambda: fk.flash_star_ref(q, k, v, info, **kw))
            lib_ms = lib_dev = None
            if fmt is None and sdpa is not None:  # SDPA computes the exact softmax
                lib_err = float((sdpa(q, k, v).float() - ref.float()).abs().max())
                lib_ms = time_ms(lambda: sdpa(q, k, v))
                lib_dev = device_ms(lambda: sdpa(q, k, v))
            variant = dict(dtype=str(dtype).split(".")[-1], mode=mode,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms)
            variant[flips_key] = flips
            if n_diff is not None:
                variant["bf16_diff_elems"] = n_diff
            extra = ""
            if pv_int8_block is None:
                dev = device_ms(lambda: fk.flash_star_attention(q, k, v, info, **kw))
                flops = 4 * n_live * d
                nbytes = (2 * q.numel() + 2 * b * hkv * kv_rows * d) * q.element_size() + 4 * info.numel()
                peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_FP32_FLOPS
                bound = max(nbytes / H100_BYTES_PER_S, flops / peak) * 1e3
                at = dev if dev is not None else ms
                design = FLASH_DESIGNS[variant["dtype"]]
                variant.update(design=design, device_ms=dev, library_device_ms=lib_dev,
                               bound_ms=bound, tflops=flops / (at * 1e-3) / 1e12,
                               share_of_bound=bound / at)
                extra = (f" device_ms={dev} library_device_ms={lib_dev} bound_ms={bound:.5f} "
                         f"tflops={variant['tflops']:.2f} share_of_bound={bound / at:.4f} "
                         f"[{design}]")
                if lib_ms is not None:
                    extra += f" sdpa_vs_plain_max_abs={lib_err:.3e}"
            if shape is not None:
                variant["shape"] = shape
            variants.append(variant)
            log(f"{name}: max_abs_err={err:.3e} {flips_key}={flips} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms}{extra}")
    return variants


def parity_flash(results):
    import torch
    import torch.nn.functional as F

    b, hq, hkv, t, d = 1, 32, 8, 512, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = [torch.randn(sh, device=dev, generator=gen) for sh in
            ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
    info = torch.tensor([0, t], dtype=torch.int32, device=dev)
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

    variants = _flash_variants("flash_star", base, info, live, sdpa=sdpa)
    variants += parity_flash_append()
    elem = 2  # bf16, the main path's type
    bytes_moved = (2 * b * hq * t * d + 2 * b * hkv * t * d) * elem + info.numel() * 4
    flops = 2 * 2 * n_live * d  # QK^T and P.V over the live (causal) scores
    main = variants[0]
    results.append(_entry(
        "flash_star", "cuda", "src/repro_torch/kernels/flash_star/csrc/flash_star.cu",
        "src/repro/kernels/flash_star/kernel.py:216", main, bytes_moved, flops,
        H100_BF16_FLOPS, variants, shape=f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] causal"))
    results[-1]["design"] = FLASH_DESIGNS
    results[-1]["lut_route"] = flash_lut_route(base, info)


def flash_lut_route(base, info):
    """bf16 STAR at the smoke shape with the default format, whose 256-level
    LUT the kernel holds in shared memory, against a format of the same
    scale with 13 bits (8192 levels, read from global memory).  Their
    entries agree up to the default's top index, beyond which no score
    difference of these inputs reaches: the same outputs bit for bit.
    Device time of both."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.kernels.flash_star import kernel as fk

    wide = FixedPointFormat(int_bits=13 - FMT.frac_bits, frac_bits=FMT.frac_bits)
    q, k, v = (x.to(torch.bfloat16) for x in base)
    out, dev = {}, {}
    for route, fmt in (("shared", FMT), ("global", wide)):
        out[route] = fk.flash_star_attention(q, k, v, info, fmt=fmt)
        dev[route] = device_ms(lambda: fk.flash_star_attention(q, k, v, info, fmt=fmt))
    torch.cuda.synchronize()
    check(torch.equal(out["shared"], out["global"]),
          "flash_star: the LUT in shared and in global memory give different outputs")
    row = {"levels": {"shared": FMT.num_levels, "global": wide.num_levels},
           "device_ms": dev}
    log(f"flash_star bf16 STAR LUT route: shared memory ({FMT.num_levels} levels) "
        f"device_ms={dev['shared']}, global memory ({wide.num_levels} levels) "
        f"device_ms={dev['global']}; outputs bit-equal")
    return row


def parity_flash_append():
    """flash_star at the chunked-prefill append shape: a 128-row q chunk at
    q_offset 256 over a 512-row staging cache whose first 384 rows are
    valid (the rest zero, as the staging buffer holds them)."""
    import torch

    b, hq, hkv, tq, tk, d, q_off, valid = 1, 32, 8, 128, 512, 128, 256, 384
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q0 = torch.randn((b, hq, tq, d), device=dev, generator=gen)
    k0, v0 = (torch.randn((b, hkv, tk, d), device=dev, generator=gen) for _ in range(2))
    k0[:, :, valid:] = 0
    v0[:, :, valid:] = 0
    info = torch.tensor([q_off, valid], dtype=torch.int32, device=dev)
    rows = q_off + torch.arange(tq, device=dev)
    cols = torch.arange(tk, device=dev)
    live = ((cols[None, :] <= rows[:, None]) & (cols[None, :] < valid))[None, None]

    def sdpa(q, k, v):  # a boolean mask: is_causal aligns top-left, so cannot offset q
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=live, enable_gqa=True)

    return _flash_variants(
        "flash_star append", (q0, k0, v0), info, live.expand(b, hq, tq, tk), sdpa=sdpa,
        shape=f"append q[{b},{hq},{tq},{d}] at q_offset {q_off}, "
              f"kv[{b},{hkv},{tk},{d}] valid {valid}")


def _pv_int8_ambiguous(scores64, live, bk, fmt):
    """Live entries whose int8 code may differ between two float32
    computations: under STAR a score near a grid half-step (its grid index,
    and with it the row's max, may flip); under the exact softmax a p near a
    half-step of 1/127, p taken against the running max after each block of
    ``bk`` columns, as the variant quantizes it."""
    import torch

    if fmt is not None:
        return near_half_step(scores64 * fmt.scale) & live
    tk = scores64.shape[-1]
    s = scores64.masked_fill(~live, float("-inf"))
    nb = -(-tk // bk)
    sp = torch.nn.functional.pad(s, (0, nb * bk - tk), value=float("-inf"))
    m_run = torch.cummax(sp.reshape(*s.shape[:-1], nb, bk).amax(-1), dim=-1).values
    p = torch.exp(s - m_run.repeat_interleave(bk, dim=-1)[..., :tk])
    return near_half_step(p * 127.0) & live


def parity_pv_int8(results):
    """The int8 P.V variant at the granite prefill shape (q [1, 32, 512,
    128], kv [1, 8, 512, 128], causal, block_k 128), then ragged: Tk 500
    with kv_valid 450 (the rows past it and the 12 zero rows that pad the
    last block count in its V absmax)."""
    import torch

    b, hq, hkv, d, bk = 1, 32, 8, 128, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    variants = []
    for t, valid in ((512, 512), (500, 450)):
        base = [torch.randn(sh, device=dev, generator=gen) for sh in
                ((b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d))]
        info = torch.tensor([0, valid], dtype=torch.int32, device=dev)
        rows = torch.arange(t, device=dev)
        live = ((rows[None, :] <= rows[:, None]) & (rows[None, :] < valid))
        live = live[None, None].expand(b, hq, t, t)
        shape = f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] valid {valid} causal block_k {bk}"
        variants += _flash_variants(f"flash_star_pv_int8 T={t}", base, info, live,
                                    shape=shape, pv_int8_block=bk)
    t = 512
    n_live = b * hq * t * (t + 1) // 2
    bytes_moved = (2 * b * hq * t * d + 2 * b * hkv * t * d) * 2 + (1 + b) * 4
    # QK^T at the bf16 tensor-core peak, P.V at the int8 peak (twice as fast):
    # counted as bf16-equivalent operations
    ops = 2 * n_live * d * (1 + H100_BF16_FLOPS / H100_INT8_OPS)
    results.append(_entry(
        "flash_star_pv_int8", "cuda", "src/repro_torch/kernels/flash_star/csrc/flash_star.cu",
        "src/repro/kernels/flash_star/kernel.py:129", variants[0], bytes_moved, ops,
        H100_BF16_FLOPS, variants, shape=variants[0]["shape"]))


def _ssd_work(b, t, h, p, n, q, bc_bytes):
    """(bytes, FLOP) of one SSD chunk scan: each input read once, each output
    written once; the live (causal) triangle of every chunk's scores."""
    bytes_moved = 4 * (2 * b * t * h * p + b * t * h + b * h * n * p) + 2 * bc_bytes * b * t * n
    flops = 0
    for t0 in range(0, t, q):
        nv = min(q, t - t0)
        pairs = nv * (nv + 1) // 2
        # scores C.B (shared by the heads); per head y_intra, y_inter, state
        flops += b * (2 * n * pairs + h * (2 * p * pairs + 4 * nv * n * p))
    return bytes_moved, flops


def parity_ssd_scan(results):
    """The SSD chunk-scan kernel against its plain version at the Mamba2
    serve's prefill shape: xdt [8, 2048, 24, 64], a [8, 2048, 24], B and C
    [8, 2048, 128] as slices of one conv output (as the mixer passes them),
    in bf16 and in float32, chunk 128; then a ragged T = 2000."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as ssk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    b, h, p, n, q = 8, 24, 64, 128, 128
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    variants = []
    for t in (2048, 2000):
        xdt = torch.randn((b, t, h, p), device=dev, generator=gen)
        a = -(torch.randn((b, t, h), device=dev, generator=gen) * 0.1).abs()
        conv = torch.randn((b, t, h * p + 2 * n), device=dev, generator=gen) * 0.3
        for dtype in (torch.bfloat16, torch.float32):
            cv = conv.to(dtype)
            bm, cm = cv[..., h * p:h * p + n], cv[..., h * p + n:]
            name = f"ssd_scan T={t} B/C {dtype}"
            y, hout = ssk.ssd_scan(xdt, a, bm, cm, chunk=q)
            y0, h0 = ssd_scan_ref(xdt, a, bm, cm, chunk=q)
            torch.cuda.synchronize()
            errs = {}
            for label, got, ref in (("y", y, y0), ("hout", hout, h0)):
                check(bool(torch.isfinite(got).all()), f"{name}: non-finite {label}")
                scale = float(ref.abs().max())
                errs[label] = float((got - ref).abs().max())
                check(errs[label] <= SSD_RTOL * scale,
                      f"{name}: {label} max err {errs[label]:.3e} > {SSD_RTOL} x "
                      f"max |plain| {scale:.3e}")
            ms = time_ms(lambda: ssk.ssd_scan(xdt, a, bm, cm, chunk=q))
            plain_ms = time_ms(lambda: ssd_scan_ref(xdt, a, bm, cm, chunk=q))
            bytes_moved, flops = _ssd_work(b, t, h, p, n, q, cv.element_size())
            t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
            t_ops = flops / H100_FP32_FLOPS * 1e3
            variants.append(dict(
                dtype=str(dtype).split(".")[-1], shape=f"T={t}", max_abs_err=errs["y"],
                hout_max_abs_err=errs["hout"], ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=bytes_moved, ops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations"))
            log(f"{name}: y max_abs_err={errs['y']:.3e} hout max_abs_err={errs['hout']:.3e} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f}")
    main = variants[0]  # T 2048, bf16 B/C: the serve's call
    results.append(_entry(
        "ssd_scan", "cuda", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:97", main, main["bytes"], main["ops"],
        H100_FP32_FLOPS, variants,
        shape=f"xdt[{b},2048,{h},{p}] a[{b},2048,{h}] B/C[{b},2048,{n}] chunk {q}; "
              "main variant bf16 B/C"))


PAGED_DESIGN = "split-KV, L = 64 rows a split, + combine"
PAGED_SHAPES = {  # name: (kv_valid per slot, table width W in blocks of 16)
    "smoke": ([0, 1, 17, 600], 38),
    # a decode tick of the fp serve's traced window: prompts of 512, 384,
    # 256 and 128 tokens after two decode steps, tables of (512 + 32) / 16
    "tick": ([514, 386, 258, 130], 34),
    # short contexts under a table of 32 rows: one split, no combine launch
    "short": ([0, 1, 17, 30], 2),
}


def _paged_work(q, lens, w, hkv, pool_elem, pages_scaled=0):
    """Bytes (q and out once, the live K/V rows once, tables, kv_valid and
    the live pages' two scales) and FP32 operations (QK^T and P.V) of one
    paged decode call."""
    s, hq, d = q.shape
    live_rows = sum(lens)
    nbytes = (2 * live_rows * hkv * d * pool_elem + 2 * q.numel() * q.element_size()
              + 4 * (s * w + s) + 2 * pages_scaled * hkv * 4)
    return nbytes, 4 * live_rows * hq * d


def _paged_variant(name, fn, ref_fn, got_dtype, scores64, live, fmt, nbytes, flops, extra):
    """One paged variant: parity against the plain version, CUDA-event time,
    device time of the split and combine kernels, bound and share."""
    import torch

    got, ref = fn(), ref_fn()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    err, flips = compare_rows(name, got, ref, got_dtype, scores64, live,
                              fmt.scale if fmt else None)
    ms = time_ms(fn)
    plain_ms = time_ms(ref_fn)
    by_kernel = device_ms_by_kernel(fn)
    split_ms = sum(t for k, t in by_kernel.items() if "paged_split_kernel" in k)
    combine_ms = sum(t for k, t in by_kernel.items() if "paged_combine_kernel" in k)
    dev = (split_ms + combine_ms) if by_kernel else None
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    at = dev if dev is not None else ms
    variant = dict(extra, max_abs_err=err, grid_flip_rows=flips, ms=ms, device_ms=dev,
                   split_device_ms=split_ms if by_kernel else None,
                   combine_device_ms=combine_ms if by_kernel else None, plain_ms=plain_ms,
                   library_ms=None, bytes=nbytes, ops=flops, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   share_of_bound=bound / at)
    log(f"{name}: max_abs_err={err:.3e} grid_flip_rows={flips} ms={ms:.4f} device_ms={dev} "
        f"(split {variant['split_device_ms']}, combine {variant['combine_device_ms']}) "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.5f} share_of_bound={bound / at:.4f}")
    return got, variant


def parity_paged(results):
    """The paged kernels (split-KV + combine) against their plain version at
    the smoke shape and at the full-width decode tick's shape (S 4, Hq 32,
    Hkv 8, D 128, bs 16): bf16 and float32 q over pools of q's type and over
    int8 / fp8_e4m3 pools, STAR and exact.  At the tick shape also a slot's
    output alone against the same slot in the batch under a wider table, and
    at the short shape (one split, no combine) each slot against the same
    slot in a batch under the tick's table width (combine): bit-equal."""
    import torch

    from repro_torch.core import kvquant
    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ref import gather_pages

    hq, hkv, d, bs = 32, 8, 128, 16
    dev = torch.device("cuda")
    variants, qvariants, splits = [], [], {}
    for shape, (lens, w) in PAGED_SHAPES.items():
        s = len(lens)
        n = s * w + 1
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 if shape == "smoke" else SEED + 8)
        base = [torch.randn(sh, device=dev, generator=gen) for sh in
                ((s, hq, d), (n, bs, hkv, d), (n, bs, hkv, d))]
        tables = (torch.randperm(n - 1, device=dev, generator=gen)[: s * w] + 1)
        tables = tables.reshape(s, w).to(torch.int32).contiguous()
        valid = torch.tensor(lens, dtype=torch.int32, device=dev)
        cols = torch.arange(w * bs, device=dev)
        live = (cols[None, :] < valid[:, None])[:, None, :].expand(s, hq, w * bs)
        splits[shape] = pk.num_splits(w, bs)
        live_pages = sum(-(-x // bs) for x in lens)
        pools = {"bf16": None}
        for kv_dtype in ("int8", "fp8_e4m3"):
            kc, ks = kvquant.quantize_blocks(base[1], kv_dtype)
            vc, vs = kvquant.quantize_blocks(base[2], kv_dtype)
            pools[kv_dtype] = (kc, vc, dict(k_scale=ks, v_scale=vs))
        for pool, coded in pools.items():
            if coded is not None:  # K as the kernel dequantizes it
                kp, vp, kw_pages = coded
                kdq = kvquant.decode(kp, kw_pages["k_scale"][:, None, :, None])
                k64 = gather_pages(kdq, kdq, tables)[0].double().repeat_interleave(hq // hkv, 2)
                elem, scaled = 1, live_pages
            for dtype in (torch.bfloat16, torch.float32):
                q = base[0].to(dtype)
                if coded is None:  # a pool of q's type
                    kp, vp = base[1].to(dtype), base[2].to(dtype)
                    kw_pages, elem, scaled = {}, q.element_size(), 0
                    k64 = gather_pages(kp, vp, tables)[0].double().repeat_interleave(hq // hkv, 2)
                scores64 = torch.einsum("shd,sthd->sht", q.double(), k64) * d ** -0.5
                nbytes, flops = _paged_work(q, lens, w, hkv, elem, scaled)
                for fmt in (FMT, None):
                    mode = "star" if fmt is not None else "exact"
                    tag = "paged" if coded is None else f"paged_quant {pool}"
                    name = f"{tag} {shape} {mode} {dtype}"
                    kw = dict(fmt=fmt, **kw_pages)
                    extra = dict(shape=shape, dtype=str(dtype).split(".")[-1], mode=mode,
                                 splits=splits[shape], split_rows=pk.SPLIT_ROWS)
                    if coded is not None:
                        extra["kv_dtype"] = pool
                    got, variant = _paged_variant(
                        name, lambda: pk.paged_flash_attention(q, kp, vp, tables, valid, **kw),
                        lambda: pk.paged_attention_ref(q, kp, vp, tables, valid, **kw),
                        dtype, scores64, live, fmt, nbytes, flops, extra)
                    check(not bool(got[valid == 0].any()), f"{name}: free slot not zero")
                    (variants if coded is None else qvariants).append(variant)
                    if shape == "short":
                        # the direct route against the combine: the same slots
                        # under the tick's width, slot 0 made long
                        w_wide = PAGED_SHAPES["tick"][1]
                        wide_tables = torch.cat([tables, torch.zeros(
                            s, w_wide - w, dtype=torch.int32, device=dev)], 1).contiguous()
                        wide_valid = valid.clone()
                        wide_valid[0] = PAGED_SHAPES["tick"][0][0]
                        wide = pk.paged_flash_attention(q, kp, vp, wide_tables, wide_valid, **kw)
                        check(torch.equal(got[1:], wide[1:]),
                              f"{name}: slots of one split (W {w}, no combine) differ from "
                              f"the same slots under W {w_wide} (combine)")
                        log(f"{name}: slots of lens {lens[1:]} alone (W {w}, 1 split, no "
                            f"combine) bit-equal under W {w_wide} "
                            f"({pk.num_splits(w_wide, bs)} splits, combine)")
                    if shape != "tick" or dtype != torch.bfloat16 or fmt is None:
                        continue
                    w0 = -(-lens[0] // bs)
                    alone = pk.paged_flash_attention(q[:1].contiguous(), kp, vp,
                                                     tables[:1, :w0].contiguous(), valid[:1], **kw)
                    check(torch.equal(alone[0], got[0]),
                          f"{name}: slot 0 alone (W {w0}) differs from slot 0 in the batch (W {w})")
                    log(f"{name}: slot 0 alone (W {w0}, {pk.num_splits(w0, bs)} splits) "
                        f"bit-equal to slot 0 in the batch (W {w}, {splits[shape]} splits)")
    desc = (f"S=4 Hq={hq} Hkv={hkv} D={d} bs={bs}; "
            + ", ".join(f"{k} lens {lens} W {w}" for k, (lens, w) in PAGED_SHAPES.items())
            + "; main variant: tick, bf16 q, STAR")
    for name, replaces, vs_, suffix in (
            ("paged_attention", "src/repro/kernels/paged_attention/kernel.py:222", variants, ""),
            ("paged_attention_quant", "src/repro/kernels/paged_attention/kernel.py:230", qvariants,
             " over int8 pages + [N,Hkv] scales (fp8_e4m3 too)")):
        main = next(v for v in vs_ if v["shape"] == "tick" and v["dtype"] == "bfloat16"
                    and v["mode"] == "star" and v.get("kv_dtype", "int8") == "int8")
        results.append(_entry(
            name, "cuda", "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            replaces, main, main["bytes"], main["ops"], H100_FP32_FLOPS, vs_,
            shape=desc + suffix))
        results[-1].update(design=PAGED_DESIGN, splits=splits, device_ms=main["device_ms"])


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
    onehot = sk.star_softmax_kernel(x, FMT, mode="onehot")
    check(torch.equal(onehot, got), "star_softmax: onehot mode is not bit-equal to gather")
    log("star_softmax onehot [4, 49152] f32: bit-equal to gather (the same function)")
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


def parity_softmax_lut(results):
    """The CUDA LUT softmax at the sampling shape [4, 49152]: clean
    histogram and the mild fault in every mode, float32 and bfloat16, against
    the plain version (the reference engine with the same realization)."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.hwmodel.faults import FaultModel
    from repro_torch.kernels.star_softmax import kernel as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    base = torch.randn(4, 49152, device=dev, generator=gen) * 4
    mild = FaultModel(**MILD)
    variants = []
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to(dtype)
        for mode, fault in (("histogram", None), ("histogram", mild), ("gather", mild),
                            ("onehot", mild)):
            name = f"star_softmax_lut {mode} {'mild fault' if fault else 'clean'} {dtype}"
            got = sk.star_softmax_kernel(x, FMT, mode=mode, fault=fault)
            ref = sk.star_softmax_ref(x, FMT, mode=mode, fault=fault)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            err = float((got - ref).abs().max())
            check(bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-9)),
                  f"{name}: max err {err:.3e} out of tolerance")
            ms = time_ms(lambda: sk.star_softmax_kernel(x, FMT, mode=mode, fault=fault))
            plain_ms = time_ms(lambda: sk.star_softmax_ref(x, FMT, mode=mode, fault=fault))
            variants.append(dict(dtype=str(dtype).split(".")[-1], mode=mode,
                                 fault="mild" if fault else None, max_abs_err=err,
                                 grid_flip_rows=0, ms=ms, plain_ms=plain_ms, library_ms=None))
            log(f"{name}: max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    levels = FMT.num_levels
    bytes_moved = 2 * base.numel() * 4 + 3 * levels * 4  # x, out, three tables
    ops = 16 * base.numel() + 2 * levels  # per element as star_softmax, plus the VMM
    main = variants[1]  # the faulty histogram in float32: the degraded serve's call
    results.append(_entry(
        "star_softmax_lut", "cuda", "src/repro_torch/kernels/star_softmax/csrc/star_softmax_lut.cu",
        "src/repro/kernels/star_softmax/kernel.py:201", main, bytes_moved, ops,
        H100_FP32_FLOPS, variants, shape="[4, 49152]; main variant f32 histogram, mild fault"))
    results[-1]["also_replaces"] = "src/repro/kernels/star_softmax/kernel.py:177 (use_histogram)"


def realization_bits() -> None:
    """A fault realization is the same bits on the card and on the CPU: the
    softmax tables, the tile offsets, and the weight-cell factor and masks
    (the first 64 rows of the q projection's [4096, 4096] realization against
    a CPU draw of [64, 4096]: element i hashes counter i whatever the shape)."""
    import torch

    from repro_torch.core.fixedpoint import DEFAULT_FORMAT as FMT
    from repro_torch.hwmodel import faults as tf

    mild = tf.FaultModel(**MILD)
    for tag in ("softmax/lut", "softmax/vmm"):
        check(torch.equal(tf.faulty_exp_lut(FMT, mild, tag, device="cuda").cpu(),
                          tf.faulty_exp_lut(FMT, mild, tag, device="cpu")),
              f"realization {tag}: card and cpu differ")
    check(torch.equal(tf.cam_remap(FMT, mild, device="cuda").cpu(), tf.cam_remap(FMT, mild)),
          "realization softmax/cam: card and cpu differ")
    check(torch.equal(tf.adc_tile_offsets(mild, (32, 112), device="cuda").cpu(),
                      tf.adc_tile_offsets(mild, (32, 112))),
          "realization matmul/adc: card and cpu differ")
    card = tf._cell_realization(mild, "matmul/w", (4096, 4096), "cuda:0")
    cpu = tf._cell_realization(mild, "matmul/w", (64, 4096), "cpu")
    for name, a, b in zip(("factor", "stuck_on", "stuck_off"), card, cpu):
        check(torch.equal(a[:64].cpu(), b), f"realization matmul/w {name}: card and cpu differ "
              f"in {int((a[:64].cpu() != b).sum())} of {b.numel()} elements")
    log("fault realization: softmax/lut, softmax/vmm, softmax/cam, matmul/adc and matmul/w "
        "bits identical on card and cpu")


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
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.hwmodel.faults import FaultModel
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.star_softmax import kernel as sk
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_smoke_config("granite_8b"), attn_impl="pallas")
    params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
    params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
    devices = (("cuda", params_gpu), ("cpu", params_cpu))

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 11, 8, 3, 19)]
    gens = [4, 2, 5, 3, 6]
    outs = {}
    with ops.use(softmax="pallas"):
        for dev, params in devices:
            eng = ContinuousBatchingEngine(
                cfg, params, ContinuousConfig(num_slots=2, max_len=40, kv_block_size=4),
                device=dev)
            outs[dev] = eng.serve(prompts, gens)
    check(outs["cuda"] == outs["cpu"],
          f"smoke greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    log(f"small reference: greedy smoke tokens identical on card and cpu "
        f"({sum(gens)} tokens, 5 requests)")

    # quantized pools, prefix cache, chunked prefill and preemption: prompts
    # share a 9-token prefix; 7 blocks of 4 rows cannot hold both slots
    rng = np.random.default_rng(SEED)
    pre = rng.integers(0, cfg.vocab_size, (9,))
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (n,))])
               for n in (3, 7, 2, 11, 5)]
    gens = [6, 4, 7, 5, 3]
    for kv_dtype in ("int8", "fp8_e4m3"):
        cb = ContinuousConfig(num_slots=2, max_len=40, kv_block_size=4, kv_pool_blocks=7,
                              kv_dtype=kv_dtype, prefix_cache=True, prefill_chunk_tokens=8)
        outs, stats = {}, {}
        with ops.use(softmax="pallas"):
            for dev, params in devices:
                eng = ContinuousBatchingEngine(cfg, params, cb, device=dev)
                outs[dev] = eng.serve(prompts, gens)
                stats[dev] = (eng.preemptions, eng.kv_stats()["prefix"]["hits"])
        check(outs["cuda"] == outs["cpu"],
              f"{kv_dtype} smoke greedy tokens differ card vs cpu: "
              f"{outs['cuda']} vs {outs['cpu']}")
        check(stats["cuda"] == stats["cpu"], f"{kv_dtype}: (preemptions, prefix hits) "
              f"differ card vs cpu: {stats}")
        preempted, hits = stats["cuda"]
        check(preempted >= 1 and hits >= 1,
              f"{kv_dtype}: expected a preemption and a prefix hit, got {stats['cuda']}")
        log(f"small reference {kv_dtype}: greedy tokens identical on card and cpu "
            f"({sum(gens)} tokens, prefix cache + 8-token chunks, {preempted} "
            f"preemptions, {hits} prefix hits)")

    # the mild fault in histogram mode: every attention row faulty (attention
    # xla -> the materialized reference path), the realization made on each
    # device; greedy decoding takes the argmax, so no sampling kernel runs
    base = get_smoke_config("granite_8b")
    fcfg = dataclasses.replace(base, softmax=dataclasses.replace(
        base.softmax_spec, fault=FaultModel(**MILD), mode="histogram"))
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 11, 8, 3, 19)]
    gens = [4, 2, 5, 3, 6]
    outs = {}
    for dev, params in devices:
        eng = ContinuousBatchingEngine(
            fcfg, params, ContinuousConfig(num_slots=2, max_len=40, kv_block_size=4), device=dev)
        outs[dev] = eng.serve(prompts, gens)
    check(outs["cuda"] == outs["cpu"],
          f"mild-fault smoke greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    log(f"small reference mild fault (histogram, faulty attention): greedy tokens identical on "
        f"card and cpu ({sum(gens)} tokens)")

    # temperature 0.8 on the card: the mode's sampling kernel launches for
    # every sampled batch (an admission or a tick)
    for mode, kernel, other in (("onehot", "star_softmax", "star_softmax_lut"),
                                ("histogram", "star_softmax_lut", "star_softmax")):
        mcfg = dataclasses.replace(cfg, softmax_mode=mode)
        with ops.use(softmax="pallas"):
            eng = ContinuousBatchingEngine(
                mcfg, params_gpu, ContinuousConfig(num_slots=2, max_len=40, kv_block_size=4,
                                                   temperature=0.8), device="cuda", seed=SEED)
            reset_launch_counts()
            out = eng.serve(prompts, gens)
            counts = launch_counts()
            tokens = torch.as_tensor(prompts[0], device="cuda")[None]
            logits, _ = build_model(mcfg).prefill(params_gpu, tokens, 40)
            scaled = logits[0, -1].float() / 0.8
            probs = ops.softmax(scaled, mcfg.softmax_spec)
        batches = len(prompts) + eng.ticks
        check([len(o) for o in out] == gens and all(0 <= t < cfg.vocab_size for o in out for t in o),
              f"smoke T=0.8 {mode}: bad output {out}")
        check(counts.get(kernel, 0) == batches and counts.get(other, 0) == 0,
              f"smoke T=0.8 {mode}: {kernel} launched {counts.get(kernel, 0)} times for "
              f"{batches} sampled batches ({other}: {counts.get(other, 0)})")
        plain = sk.star_softmax_ref(scaled.cpu(), mcfg.softmax_spec.fmt, mode=mode)
        err = float((probs.cpu() - plain).abs().max())
        check(bool(torch.allclose(probs.cpu(), plain, rtol=1e-5, atol=1e-9)),
              f"smoke T=0.8 {mode}: first sample's probabilities differ from the cpu plain "
              f"version (max err {err:.3e})")
        log(f"small reference T=0.8 {mode}: {kernel} launched {counts[kernel]} times for "
            f"{batches} sampled batches; first sample's probabilities vs cpu plain version "
            f"max_abs_err={err:.3e}")


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
    need = {"flash_star": cfg.num_layers * len(prompts), "star_softmax": eng.ticks}
    for name, least in need.items():
        check(counts.get(name, 0) >= least,
              f"serve: {name} launched {counts.get(name, 0)} times, expected >= {least}")
    check(counts.get("paged_attention", 0) == cfg.num_layers * eng.ticks,
          f"serve: paged_attention launched {counts.get('paged_attention', 0)} times, not "
          f"once per layer of each of {eng.ticks} ticks")
    for entry in results:
        entry["launches"] = counts.get(entry["name"], 0)
        entry["launches_by_path"] = {"serve_fp": entry["launches"]}

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
    longest = torch.as_tensor(max(prompts, key=len), device="cuda")[None]
    with torch.no_grad():
        profile_window(f"one full-width prefill, {longest.shape[1]} tokens",
                       lambda: model.prefill(params, longest, 512))
    profile_tick(cfg, params)
    pv_int8 = prefill_pv_int8(results, cfg, params, max(prompts, key=len)[:512])
    return {"tokens": len(toks), "wall_s": wall, "tok_per_s": len(toks) / wall,
            "ticks": eng.ticks, "ttft_p50_s": ttft.percentile(50),
            "max_memory_allocated": peak, "prefill_pv_int8": pv_int8}, params


def prefill_pv_int8(results, cfg, params, prompt):
    """The int8 P.V path: a full-width granite-8b prefill whose attention
    spec sets ``pv_int8`` (``ops.attention(..., pv_int8=True)`` in every
    layer), counters zeroed just before and read just after; its logits held
    against the same prefill through the float P.V kernel."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.registry import build_model

    icfg = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, pv_int8=True))
    check(icfg.attention_spec.pv_int8 and icfg.attention_spec.impl == "pallas",
          f"pv_int8 config resolves to {icfg.attention_spec}")
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    with torch.no_grad():
        ref, _ = build_model(cfg).prefill(params, tokens, tokens.shape[1])
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got, _ = build_model(icfg).prefill(params, tokens, tokens.shape[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "pv_int8 prefill: non-finite logits")
    rel = float((got - ref).norm() / ref.norm())
    log(f"pv_int8 prefill: granite-8b, {tokens.shape[1]} tokens, {wall:.3f}s, launches {counts}; "
        f"logits vs the float P.V kernel rel_l2={rel:.3e}")
    check(counts.get("flash_star_pv_int8", 0) == cfg.num_layers and
          counts.get("flash_star", 0) == 0,
          f"pv_int8 prefill: launches {counts}, expected flash_star_pv_int8 x {cfg.num_layers}")
    check(rel < 3e-2, f"pv_int8 prefill logits differ from the float P.V: rel_l2={rel:.3e}")
    for e in results:
        e["launches_by_path"]["prefill_pv_int8"] = counts.get(e["name"], 0)
        if e["name"] == "flash_star_pv_int8":
            e["launches"] = counts["flash_star_pv_int8"]
    return {"tokens": int(tokens.shape[1]), "wall_s": wall, "logits_rel_l2": rel}


def profile_window(label, fn) -> None:
    """Device time of ``fn`` by kernel group, from ``torch.profiler``;
    where the profiler records no device time the breakdown is reported as
    not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _self_device_us(ev)
        name = ev.key.lower()
        if "paged_split_kernel" in name or "paged_combine_kernel" in name:
            group = "paged_attention"  # the fp and the quantized kernels alike
        elif "flash_star_pv_int8_kernel" in name:
            group = "flash_star_pv_int8"
        elif "flash_star" in name:  # flash_star_kernel (fp32), flash_star_mma_kernel (bf16)
            group = "flash_star"
        elif "ssd_scan_kernel" in name:
            group = "ssd_scan"
        elif "star_softmax_rows" in name:
            group = "star_softmax"
        elif "star_softmax_lut_kernel" in name:
            group = "star_softmax_lut"
        elif "crossbar_kernel" in name:
            group = "crossbar_matmul"
        elif any(g in name for g in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
            group = "gemm"
        elif "copy" in name or "cast" in name or "convert" in name:
            group = "copy/cast"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + us
    busy = sum(groups.values())
    if busy <= 0:
        log(f"profile: {label}: the profiler recorded no device time (breakdown not measured)")
        return
    shares = {g: round(us / busy, 4) for g, us in sorted(groups.items(), key=lambda x: -x[1])}
    log(f"profile: {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.1%} of wall); device time by group "
        f"(ms): { {g: round(us / 1e3, 3) for g, us in groups.items()} }; shares {shares}")


def profile_tick(cfg, params, kv_dtype="fp32", guard=None, label="") -> None:
    """One full-width decode tick with 4 active slots, traced."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cb = ContinuousConfig(num_slots=4, max_len=512 + 32, temperature=0.8, kv_block_size=16,
                          kv_dtype=kv_dtype, guard=guard)
    eng = ContinuousBatchingEngine(cfg, params, cb, device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    for n in (512, 384, 256, 128):
        eng.submit(rng.integers(0, cfg.vocab_size, (n,)), 4)
    with ops.use(softmax="pallas"):
        eng.step()  # admissions and the first tick, outside the trace
        profile_window(f"one decode tick, 4 slots, {kv_dtype} pool{label}", eng.step)


def profile_chunk(cfg, model, params) -> None:
    """One full-width 128-token ``prefill_extend`` chunk at q_offset 256,
    traced: the unit of work chunked prefill repeats."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 6)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 384)), device="cuda")
    with torch.no_grad():
        _, cache = model.prefill(params, tokens[:, :256], 512)
        profile_window("one 128-token prefill chunk at q_offset 256",
                       lambda: model.prefill_extend(params, cache, tokens[:, 256:]))


# ---------------------------------------------------------------------------
# phase 6: quantized serve at full width (int8 pool, prefix cache, chunks)

QUANT_POOL_BLOCKS = 80  # forces preemptions for the plan below (4 slots want ~116)


def quant_serve_plan(vocab):
    """8 requests: a common 256-token system prefix (16 full blocks) plus
    each request's own 64-256-token suffix, 16-32 new tokens.  Lengths are
    drawn before tokens, so they do not depend on the vocabulary."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    suffix = [int(n) for n in rng.integers(64, 257, 8)]
    gens = [int(g) for g in rng.integers(16, 33, 8)]
    system = rng.integers(0, vocab, (256,))
    prompts = [np.concatenate([system, rng.integers(0, vocab, (n,))]) for n in suffix]
    return prompts, gens


def serve_quant(results, params):
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = dataclasses.replace(get_config("granite_8b"), attn_impl="pallas")
    model = build_model(cfg)
    prompts, gens = quant_serve_plan(cfg.vocab_size)
    cb = ContinuousConfig(num_slots=4, max_len=256 + 256 + 32, temperature=0.8,
                          kv_block_size=16, kv_pool_blocks=QUANT_POOL_BLOCKS,
                          kv_dtype="int8", prefix_cache=True, prefill_chunk_tokens=128)
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
    check([len(s) for s in out] == gens,
          f"serve int8: generated lengths {[len(s) for s in out]} != {gens}")
    check(all(0 <= t < cfg.vocab_size for t in toks), "serve int8: a token outside the vocabulary")
    st = eng.kv_stats()
    prefills = int(eng.metrics.counter("serve.prefill.calls").value())
    ttft = eng.metrics.histogram("serve.ttft_s")
    peak = torch.cuda.max_memory_allocated()
    log(f"serve int8: {len(prompts)} requests, prompts {[len(p) for p in prompts]}, "
        f"{len(toks)} tokens in {wall:.3f}s = {len(toks) / wall:.2f} tok/s, "
        f"{eng.ticks} decode ticks, {prefills} prefill chunks, "
        f"ttft p50={1e3 * ttft.percentile(50):.1f}ms, max_memory_allocated={peak / 2**30:.2f} GiB, "
        f"{eng.preemptions} preemptions, prefix {st['prefix']}, "
        f"kv bytes/token {st['kv_bytes_per_token']:.1f}")
    log(f"serve int8: launches {counts}")
    check(st["prefix"]["hits"] >= 1, "serve int8: no prefix-cache hit")
    check(eng.preemptions >= 1, "serve int8: the pool forced no preemption")
    check(counts.get("paged_attention_quant", 0) == cfg.num_layers * eng.ticks,
          f"serve int8: paged_attention_quant launched {counts.get('paged_attention_quant', 0)} "
          f"times, expected {cfg.num_layers * eng.ticks}")
    check(counts.get("flash_star", 0) == cfg.num_layers * prefills,
          f"serve int8: flash_star launched {counts.get('flash_star', 0)} times for "
          f"{prefills} chunks of {cfg.num_layers} layers")
    check(counts.get("star_softmax", 0) >= eng.ticks,
          f"serve int8: star_softmax launched {counts.get('star_softmax', 0)} times")
    check(counts.get("paged_attention", 0) == 0, "serve int8: the fp paged kernel ran")
    for entry in results:
        n = counts.get(entry["name"], 0)
        entry["launches_by_path"]["serve_int8"] = n
        if entry["name"] == "paged_attention_quant":
            entry["launches"] = n
    rel = quant_decode_step(cfg, model, params, prompts[:4])
    profile_tick(cfg, params, kv_dtype="int8")
    profile_chunk(cfg, model, params)
    return {"tokens": len(toks), "wall_s": wall, "tok_per_s": len(toks) / wall,
            "ticks": eng.ticks, "prefill_chunks": prefills,
            "ttft_p50_s": ttft.percentile(50), "max_memory_allocated": peak,
            "preemptions": eng.preemptions, "prefix": st["prefix"],
            "decode_step_logits_rel_l2": rel}


def quant_decode_step(cfg, model, params, prompts) -> float:
    """One full-width decode step over an int8 pool through the kernel,
    held against the same step through the ``reference`` paged impl (the
    gather + dequant plain path) on a copy of the same pool."""
    import torch

    from repro_torch import ops
    from repro_torch.models.param import tree_map

    bs, rows = 16, 256
    w = rows // bs + 1
    pool = model.init_paged_cache(len(prompts) * w + 1, bs, len(prompts), device="cuda",
                                  kv_dtype="int8")
    tables = torch.arange(1, len(prompts) * w + 1, dtype=torch.int32,
                          device="cuda").reshape(len(prompts), w)
    with torch.no_grad():
        for slot, p in enumerate(prompts):
            tokens = torch.as_tensor(p[:rows - 16 * slot], device="cuda")[None]
            _, cache = model.prefill(params, tokens, w * bs)
            model.write_slot_paged(pool, cache, slot, tables[slot])
        nxt = torch.as_tensor([[int(p[-1])] for p in prompts], device="cuda")
        pool_ref = tree_map(lambda t: t.clone(), pool)
        got, _ = model.decode_step_paged(params, pool, nxt, tables, cache_t=w * bs)
        with ops.use(paged_attention="reference"):
            ref, _ = model.decode_step_paged(params, pool_ref, nxt, tables, cache_t=w * bs)
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "int8 decode step: non-finite logits")
    rel = float((got - ref).norm() / ref.norm())
    log(f"full-width int8 decode step logits, kernel vs reference paged impl: rel_l2={rel:.3e} "
        f"max_abs={float((got - ref).abs().max()):.3e}")
    check(rel < 3e-2, f"int8 decode step logits differ from the reference: rel_l2={rel:.3e}")
    return rel


# ---------------------------------------------------------------------------
# phase 7: serve on a degraded RRAM device, the crossbar MatMul engine


def _degraded_engine(params, fault_kw, mode, guard):
    from repro_torch.configs import get_config
    from repro_torch.hwmodel.faults import FaultModel
    from repro_torch.serve.engine import ContinuousBatchingEngine, ContinuousConfig

    cfg = get_config("granite_8b")  # attention xla: faulty rows -> the reference path
    cfg = dataclasses.replace(cfg, softmax=dataclasses.replace(
        cfg.softmax_spec, fault=FaultModel(**fault_kw), mode=mode))
    cb = ContinuousConfig(num_slots=4, max_len=256 + 16, temperature=0.8, kv_block_size=16,
                          guard=guard)
    return cfg, ContinuousBatchingEngine(cfg, params, cb, device="cuda", seed=SEED)


def degraded_serve(results, params):
    import warnings

    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.kernels import launch_counts, reset_launch_counts

    from repro_torch.configs import get_config

    rng = np.random.default_rng(SEED + 8)
    lens = [int(n) for n in rng.integers(128, 257, 4)]
    prompts = [rng.integers(0, get_config("granite_8b").vocab_size, (n,)) for n in lens]
    gens = [16] * 4
    by_name = {e["name"]: e for e in results}
    summary = {}

    # 7a: the mild fault, histogram mode, a guard that checks every call and
    # never latches, so the LUT kernel serves every sampled batch
    with ops.use(softmax="pallas"):
        cfg, eng = _degraded_engine(params, MILD, "histogram", ops.GuardConfig(latch=False))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ops.GuardTripWarning)
            out = eng.serve(prompts, gens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    toks = [t for o in out for t in o]
    g = eng.stats()["guard"]
    batches = len(prompts) + eng.ticks
    ttft = eng.metrics.histogram("serve.ttft_s").percentile(50)
    peak = torch.cuda.max_memory_allocated()
    log(f"degraded 7a (mild fault, histogram, guard latch=False): prompts {lens}, {len(toks)} "
        f"tokens in {wall:.3f}s = {len(toks) / wall:.2f} tok/s, {eng.ticks} ticks, ttft "
        f"p50={1e3 * ttft:.1f}ms, max_memory_allocated={peak / 2**30:.2f} GiB, guard {g}, "
        f"launches {counts}")
    check([len(o) for o in out] == gens and all(0 <= t < cfg.vocab_size for t in toks),
          "degraded 7a: bad output")
    check(g["calls"] == batches and g["checks"] == g["calls"],
          f"degraded 7a: guard calls/checks {g['calls']}/{g['checks']}, {batches} sampled batches")
    check(counts.get("star_softmax_lut", 0) == batches,
          f"degraded 7a: star_softmax_lut launched {counts.get('star_softmax_lut', 0)} times for "
          f"{batches} sampled batches")
    check(counts.get("flash_star", 0) == 0 and counts.get("paged_attention", 0) == 0,
          "degraded 7a: an attention kernel ran on a faulty spec")
    by_name["star_softmax_lut"]["launches"] = counts["star_softmax_lut"]
    for e in results:
        e["launches_by_path"]["degraded_mild"] = counts.get(e["name"], 0)
    summary["mild_histogram"] = {"tokens": len(toks), "wall_s": wall,
                                 "tok_per_s": len(toks) / wall, "ticks": eng.ticks,
                                 "ttft_p50_s": ttft, "max_memory_allocated": peak, "guard": g}
    profile_tick(cfg, params, guard=ops.GuardConfig(latch=False), label=", mild fault")

    # 7b: a severe fault, gather mode, a latching guard: the kernel runs until
    # the first check trips, then the clean path serves.  The format's
    # provable bound e^r - 1 (0.284) is absolute, and over a 49152-token
    # vocabulary the sampling distribution of random weights is flat (largest
    # probability ~1e-3 at T=0.8), so no fault can exceed it there; the
    # budget is twice the clean engine's own error on the first prompt's
    # sampling logits instead
    from repro_torch.models.registry import build_model

    clean_cfg = get_config("granite_8b")
    with torch.no_grad():
        tokens = torch.as_tensor(prompts[0], device="cuda")[None]
        logits, _ = build_model(clean_cfg).prefill(params, tokens, 256 + 16)
    scaled = logits[0, -1].float() / 0.8
    clean_err = float((ops.softmax(scaled, ops.SoftmaxSpec(impl="pallas"))
                       - torch.softmax(scaled, dim=-1)).abs().max())
    budget = 2 * clean_err
    log(f"degraded 7b: clean STAR sampling error on the first prompt {clean_err:.3e} "
        f"(largest exact probability {float(torch.softmax(scaled, -1).max()):.3e}); "
        f"guard tolerance {budget:.3e}")
    with ops.use(softmax="pallas"):
        cfg, eng = _degraded_engine(params, SEVERE, "gather", ops.GuardConfig(tolerance=budget))
        for p in prompts:
            eng.submit(p, 16)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        history = []
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            while not eng.scheduler.done():
                eng.step()
                history.append((launch_counts().get("star_softmax_lut", 0), eng.guard.tripped))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    g = eng.stats()["guard"]
    trips = [w for w in rec if issubclass(w.category, ops.GuardTripWarning)]
    toks = [t for o in eng.scheduler.finished.values() for t in o]
    ttft = eng.metrics.histogram("serve.ttft_s").percentile(50)
    peak = torch.cuda.max_memory_allocated()
    log(f"degraded 7b (severe fault, gather, latching guard): {len(toks)} tokens in {wall:.3f}s "
        f"= {len(toks) / wall:.2f} tok/s, {eng.ticks} ticks, ttft p50={1e3 * ttft:.1f}ms, "
        f"max_memory_allocated={peak / 2**30:.2f} GiB, guard {g}, {len(trips)} GuardTripWarning, "
        f"kernel launches by step {[n for n, _ in history]}")
    check(g["trips"] >= 1 and g["tripped"] and g["fallbacks"] >= 1 and trips,
          f"degraded 7b: the guard did not trip and latch: {g}")
    first = next(i for i, (_, tripped) in enumerate(history) if tripped)
    at_trip = history[first][0]
    check(at_trip >= 1, "degraded 7b: the LUT kernel did not run before the trip")
    check(all(n == at_trip for n, _ in history[first:]),
          "degraded 7b: the LUT kernel launched after the guard latched")
    check(counts["star_softmax_lut"] == g["calls"] - g["fallbacks"] + g["trips"],
          f"degraded 7b: {counts['star_softmax_lut']} launches for guard {g}")
    check(all(0 <= t < cfg.vocab_size for t in toks) and len(toks) == sum(gens),
          "degraded 7b: bad output")
    for e in results:
        e["launches_by_path"]["degraded_severe"] = counts.get(e["name"], 0)
    summary["severe_gather"] = {"tokens": len(toks), "wall_s": wall,
                                "tok_per_s": len(toks) / wall, "ticks": eng.ticks,
                                "ttft_p50_s": ttft, "max_memory_allocated": peak, "guard": g,
                                "lut_launches": counts["star_softmax_lut"]}

    # the crossbar MatMul engine at granite-8b's q and MLP-up projection
    # widths (layer 0's weights), under a guard that checks every call
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = torch.randn(256, 4096, device="cuda", generator=gen)
    weights = {"q_proj": params["blocks"]["attn"]["wq"][0],
               "mlp_up": params["blocks"]["mlp"]["wi"][0]}
    guard = ops.AccuracyGuard(ops.GuardConfig(latch=False))
    mm = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ops.GuardTripWarning)
        for name, w in weights.items():
            for label, fault in (("clean", None), ("mild", ops.FaultModel(**MILD))):
                t0 = time.perf_counter()
                out = ops.matmul(x, w, ops.MatmulSpec(impl="hwmodel", fault=fault), guard=guard)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()), f"matmul {name} {label}: non-finite")
                mm[f"{name} {label}"] = {"rel_max_abs_err": guard.last_error,
                                         "wall_s": time.perf_counter() - t0}
    counts = launch_counts()
    log(f"matmul hwmodel [256, 4096] @ layer 0 q_proj [4096, 4096] / mlp_up [4096, 14336]: "
        f"{mm}; guard {guard.stats()}; launches {counts}")
    check(counts.get("crossbar_matmul", 0) == 4,
          f"matmul hwmodel: crossbar_matmul launched {counts.get('crossbar_matmul', 0)} times, "
          "expected 4")
    summary["matmul_hwmodel"] = {"calls": mm, "guard": guard.stats()}
    parity_crossbar(results, x, weights, counts["crossbar_matmul"])
    return summary


def parity_crossbar(results, x, weights, launches):
    """The crossbar kernel against its plain version at the projection
    shapes: clean outputs bit-exact; faulty ones equal but for ADC codes
    within FLIP_DELTA LSB of a half-step, at most FLIP_BOUND of the outputs."""
    import torch

    from repro_torch.hwmodel import faults as tf
    from repro_torch.kernels.crossbar_matmul import kernel as xk
    from repro_torch.kernels.crossbar_matmul import ref as xr

    variants = []
    for name, w in weights.items():
        for label, fault in (("clean", None), ("mild", tf.FaultModel(**MILD))):
            xq, wq, step, off, _ = xr.prepare_operands(x, w, fault=fault)
            got = xk.crossbar_matmul(xq, wq, step, off)
            ref = xr.crossbar_accumulate_ref(xq, wq, step, off)
            torch.cuda.synchronize()
            tag = f"crossbar {name} {label}"
            check(bool(torch.isfinite(got).all()), f"{tag}: non-finite")
            differ = got != ref
            flips = int(differ.sum())
            if fault is None:
                check(flips == 0, f"{tag}: {flips} outputs differ from the plain version")
            elif flips:
                kt = xq.shape[1] // 128
                xd, wd = xq.double(), wq.double()
                near = torch.zeros_like(differ)
                for i in range(kt):
                    code = (xd[:, i * 128:(i + 1) * 128] @ wd[i * 128:(i + 1) * 128]) / \
                        step[i].double().repeat_interleave(128)
                    if off is not None:
                        code = code + off[i].double().repeat_interleave(128)
                    near |= (code - code.floor() - 0.5).abs() < FLIP_DELTA
                check(not bool((differ & ~near).any()),
                      f"{tag}: outputs differ with no ADC code near a half-step")
                check(flips <= FLIP_BOUND * got.numel(),
                      f"{tag}: {flips} ADC flips exceed {FLIP_BOUND} of {got.numel()} outputs")
            err = float((got - ref).abs()[~differ].max()) if bool((~differ).any()) else 0.0
            ms = time_ms(lambda: xk.crossbar_matmul(xq, wq, step, off))
            plain_ms = time_ms(lambda: xr.crossbar_accumulate_ref(xq, wq, step, off))
            m, k = xq.shape
            n = wq.shape[1]
            # the kernel reads int8 codes, and float32 weights under a fault
            bytes_moved = (m * k + k * n * (4 if fault is not None else 1)
                           + step.numel() * 4 * (1 if off is None else 2) + m * n * 4)
            peak = H100_INT8_OPS if fault is None else H100_FP32_FLOPS
            t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
            t_ops = 2 * m * n * k / peak * 1e3
            variants.append(dict(
                shape=f"[{m}, {k}] @ {name} [{k}, {n}]", fault=label, max_abs_err=err,
                adc_flips=flips, ms=ms, plain_ms=plain_ms, library_ms=None,
                bytes=bytes_moved, ops=2 * m * n * k, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations"))
            log(f"{tag}: [{m}, {k}] @ [{k}, {n}] max_abs_err={err:.3e} adc_flips={flips} "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={max(t_bytes, t_ops):.5f}")
    main = variants[2]  # mlp_up, clean
    entry = _entry("crossbar_matmul", "cuda",
                   "src/repro_torch/kernels/crossbar_matmul/csrc/crossbar_matmul.cu",
                   "src/repro/kernels/crossbar_matmul/kernel.py:69", main, main["bytes"],
                   main["ops"], H100_INT8_OPS, variants,
                   shape=f"{main['shape']}, clean int8 (main); faulty float32 weights in variants")
    entry["launches"] = launches
    entry["launches_by_path"] = {"matmul_hwmodel": launches}
    results.append(entry)


# ---------------------------------------------------------------------------
# phase 8: Mamba2 on the lockstep engine


def small_reference_mamba():
    """The mamba2-130m smoke config served greedy on the card (the kernels)
    and on the CPU (their plain versions) with the same weights: the same
    tokens.  The prompts (21 tokens) are ragged against the chunk (16)."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import materialize, tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_smoke_config("mamba2_130m")
    params_cpu = materialize(build_model(cfg).param_specs(), SEED, "cpu")
    params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
    prompts = np.random.default_rng(SEED + 11).integers(0, cfg.vocab_size, (3, 21))
    outs, counts = {}, {}
    with ops.use(softmax="pallas"):
        for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
            reset_launch_counts()
            toks, _ = ServeEngine(cfg, params, ServeConfig(max_len=64), device=dev).generate(
                prompts, 8)
            torch.cuda.synchronize()
            outs[dev], counts[dev] = toks.cpu().tolist(), launch_counts()
    check(outs["cuda"] == outs["cpu"],
          f"mamba2 smoke greedy tokens differ card vs cpu: {outs['cuda']} vs {outs['cpu']}")
    check(counts["cuda"].get("ssd_scan", 0) == cfg.num_layers,
          f"mamba2 smoke: ssd_scan launched {counts['cuda'].get('ssd_scan', 0)} times on the "
          f"card for {cfg.num_layers} layers")
    log(f"small reference mamba2: greedy smoke tokens identical on card and cpu "
        f"(3 x 8 tokens, prompts of 21, chunk {cfg.ssm_chunk}); card launches {counts['cuda']}")


def serve_mamba(results):
    """mamba2-130m at its published widths and all 24 layers, random weights
    drawn on the card from the seed, on the lockstep engine: 8 prompts of
    2048 tokens, 32 new tokens each, temperature 0.8, sampling softmax
    ``pallas``.  Counters zeroed just before the serve and read just after:
    ``ssd_scan`` once per layer of the prefill, the STAR softmax once per
    sampled step.  Then one full-width prefill through the kernel against the
    same prefill under ``ops.use(ssd_scan="reference")``, and one prefill and
    one decode step traced."""
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param import count_params, materialize
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine, sample_token

    cfg = get_config("mamba2_130m")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = materialize(model.param_specs(), SEED, "cuda")
    torch.cuda.synchronize()
    log(f"serve mamba2: {cfg.name} {cfg.num_layers}L d={cfg.d_model} "
        f"{count_params(model.param_specs()) / 1e6:.1f}M params ({cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}) drawn in {time.perf_counter() - t0:.1f}s")
    b, t, gen = 8, 2048, 32
    prompts = np.random.default_rng(SEED + 12).integers(0, cfg.vocab_size, (b, t))
    tokens = torch.as_tensor(prompts, device="cuda")
    sc = ServeConfig(max_len=t + gen, temperature=0.8)
    with ops.use(softmax="pallas"), torch.no_grad():
        eng = ServeEngine(cfg, params, sc, device="cuda", seed=SEED)
        eng.generate(prompts[:, :256], 2)  # warm-up: the sampling kernel at this vocabulary
        # time to first token, alone: the prefill and the first sample
        gens = [torch.Generator(device="cuda").manual_seed(SEED + i) for i in range(b)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tokens, t + gen)
        nxt = sample_token(logits[:, -1], gens, cfg, 0.8)[:, None]
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        # the time of one decode step (and its sample), over 8 steps
        t0 = time.perf_counter()
        for _ in range(8):
            logits, cache = model.decode_step(params, cache, nxt)
            nxt = sample_token(logits[:, -1], gens, cfg, 0.8)[:, None]
        torch.cuda.synchronize()
        step = (time.perf_counter() - t0) / 8
        del cache, logits
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        toks, info = eng.generate(prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    out = toks.cpu().numpy()
    check(out.shape == (b, gen) and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"serve mamba2: bad output {out.shape}")
    check(info["cache_len"] == t + gen - 1, f"serve mamba2: cache_len {info['cache_len']}")
    log(f"serve mamba2: {b} x {t}-token prompts, {b * gen} tokens in {wall:.3f}s = "
        f"{b * gen / wall:.2f} tok/s; ttft (prefill + first sample) {1e3 * ttft:.1f}ms, "
        f"decode step {1e3 * step:.2f}ms, max_memory_allocated={peak / 2**30:.2f} GiB, "
        f"cache_len {info['cache_len']}")
    log(f"serve mamba2: launches {counts}")
    check(counts.get("ssd_scan", 0) == cfg.num_layers,
          f"serve mamba2: ssd_scan launched {counts.get('ssd_scan', 0)} times, "
          f"expected {cfg.num_layers} (one per layer of the prefill)")
    check(counts.get("star_softmax", 0) == gen,
          f"serve mamba2: star_softmax launched {counts.get('star_softmax', 0)} times for "
          f"{gen} sampled steps")
    for e in results:
        e["launches_by_path"]["serve_mamba2"] = counts.get(e["name"], 0)
        if e["name"] == "ssd_scan":
            e["launches"] = counts["ssd_scan"]

    # one full-width prefill through the kernel vs the plain chunk scan, in
    # the serve's bf16 compute and in float32 compute (where no bf16
    # rounding of the mixer output can absorb the scans' float32 differences)
    rels = {}
    for dtype in ("bfloat16", "float32"):
        dcfg = dataclasses.replace(cfg, compute_dtype=dtype)
        dmodel = build_model(dcfg)
        with torch.no_grad():
            reset_launch_counts()
            got, _ = dmodel.prefill(params, tokens, t + gen)
            n_kernel = launch_counts().get("ssd_scan", 0)
            with ops.use(ssd_scan="reference"):
                ref, _ = dmodel.prefill(params, tokens, t + gen)
            n_ref = launch_counts().get("ssd_scan", 0) - n_kernel
        check(n_kernel == cfg.num_layers and n_ref == 0,
              f"mamba2 prefill {dtype}: ssd_scan launched {n_kernel} times on the kernel "
              f"route and {n_ref} times on the reference route")
        # the vocabulary's own columns: the padding columns hold -1e30
        got, ref = got[..., :cfg.vocab_size].float(), ref[..., :cfg.vocab_size].float()
        check(bool(torch.isfinite(got).all()), f"mamba2 prefill {dtype}: non-finite logits")
        rels[dtype] = float((got - ref).norm() / ref.norm())
        log(f"full-width mamba2 prefill logits [8, 2048], {dtype} compute, kernel vs reference "
            f"chunk scan: rel_l2={rels[dtype]:.3e} max_abs={float((got - ref).abs().max()):.3e}")
        check(rels[dtype] < 3e-2,
              f"mamba2 prefill {dtype} logits differ from the reference: rel_l2={rels[dtype]:.3e}")
    rel = rels["bfloat16"]
    with torch.no_grad():
        profile_window("mamba2 prefill, 8 x 2048 tokens",
                       lambda: model.prefill(params, tokens, t + gen))
        _, cache = model.prefill(params, tokens, t + gen)
        profile_window("mamba2 decode step, batch 8",
                       lambda: model.decode_step(params, cache, tokens[:, -1:]))
    return {"batch": b, "prompt_len": t, "gen": gen, "tokens": b * gen, "wall_s": wall,
            "tok_per_s": b * gen / wall, "ttft_s": ttft, "decode_step_s": step,
            "max_memory_allocated": peak, "prefill_logits_rel_l2": rel,
            "prefill_logits_rel_l2_f32_compute": rels["float32"]}


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
    from repro_torch.kernels.crossbar_matmul import kernel as xk
    from repro_torch.kernels.flash_star import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.ssd_scan import kernel as ssk
    from repro_torch.kernels.star_softmax import kernel as sk

    t0 = time.perf_counter()
    logs = _cuda.build([fk.SOURCE, pk.SOURCE, sk.LUT_SOURCE, xk.SOURCE, ssk.SOURCE])
    log(f"build: {time.perf_counter() - t0:.1f}s (nvcc, all five sources at once)")
    for path, text in logs.items():
        for func, lines in ptxas_by_function(text).items():
            log(f"  {path.name} {func}: {'; '.join(lines)}")
    check_mma_build(logs[fk.SOURCE], _cuda.library_path(fk.SOURCE))
    check_paged_build(logs[pk.SOURCE])

    results = []
    parity_flash(results)
    parity_pv_int8(results)
    parity_paged(results)
    parity_softmax(results)
    parity_softmax_lut(results)
    parity_ssd_scan(results)
    realization_bits()
    small_reference()
    small_reference_mamba()
    summary, params = serve(results)
    summary_quant = serve_quant(results, params)
    summary_degraded = degraded_serve(results, params)
    del params
    torch.cuda.empty_cache()
    summary_mamba = serve_mamba(results)
    for entry in results:
        check(entry["launches"] > 0, f"{entry['name']} never launched on the main path")
    log(json.dumps({"serve": summary, "serve_int8": summary_quant,
                    "serve_degraded": summary_degraded, "serve_mamba2": summary_mamba,
                    "card": card}))
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
