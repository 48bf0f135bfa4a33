"""The traced run's device view: ``torch.profiler`` over a short steady
window of engine steps, checked against the port's launch counters.

The profiler now and then loses kernel records (their kernels ran).  So the
records of each kernel the port counts (``repro_torch.kernels.launch_counts``)
must equal the launches counted over the same window; a window that falls
short, or records no device time, is profiled again, and one still short
after ``tries`` windows gives no profile: a share is never computed from a
short record.

Kernel groups are those the port's chip checks use (``gemm``, ``copy/cast``,
``other``, ``sort`` and the port's own kernels by name).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from harness.driver import STEP_LABEL

# the port's launch counters and the kernel names each counts, one a launch
COUNTED_KERNELS = {
    "flash_star": ("flash_star_mma_kernel", "flash_star_tf32_kernel"),
    "paged_attention": ("paged_split_kernel",),
    "ssd_scan": ("ssd_state_pass_kernel",),  # of its three, the one every call launches
    "star_softmax": ("star_softmax_lut_kernel",),
}
WINDOW_LABEL = "bench.profiled_window"
LABELS = (WINDOW_LABEL, STEP_LABEL)
TOP = 10  # entries of each breakdown list


def kernel_group(name: str) -> str:
    name = name.lower()
    if "paged_split_kernel" in name or "paged_combine_kernel" in name:
        return "paged_attention"
    if "flash_star_quantize_v_kernel" in name or "flash_star_pv_int8_kernel" in name:
        return "flash_star_pv_int8"
    if "flash_star" in name:
        return "flash_star"
    if "ssd_" in name and "kernel" in name:
        return "ssd_scan"
    if "star_softmax_lut_kernel" in name:
        return "star_softmax"
    if "crossbar_tc_kernel" in name or "crossbar_scalar_kernel" in name:
        return "crossbar_matmul"
    if "sort" in name:
        return "sort"
    if any(g in name for g in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "gemm"
    if "copy" in name or "cast" in name or "convert" in name or "memcpy" in name:
        return "copy/cast"
    return "other"


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]  # name: (seconds, records)
    groups: Dict[str, float]  # group: seconds
    launches: Dict[str, int]  # counted launches in the window
    idle_gaps: List[Tuple[str, float]]  # (what the host was doing, seconds), longest first
    first_step: int  # the loop's steps [first_step, last_step) ran in the window
    last_step: int

    def group_s(self, *groups: str) -> float:
        return sum(self.groups.get(g, 0.0) for g in groups)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_host(busy: List[Tuple[float, float]], w0: float, w1: float,
                 host: List[Tuple[float, float, str]]) -> List[Tuple[str, float]]:
    """Idle time of ``[w0, w1]`` outside the merged ``busy`` intervals, summed
    by the innermost host event (start, end, name) open at each gap's middle
    (``host``: sorted by start), longest first (times in microseconds, the
    result in seconds).  One sweep: host events nest, so the open ones form
    a stack."""
    totals: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    nxt = 0
    t = w0
    for a, b in busy + [(w1, w1)]:
        a, b = min(max(a, w0), w1), min(b, w1)
        if a > t:
            mid = 0.5 * (t + a)
            while nxt < len(host) and host[nxt][0] <= mid:
                while stack and stack[-1][1] < host[nxt][0]:
                    stack.pop()
                stack.append(host[nxt])
                nxt += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "host: no event"
            totals[label] = totals.get(label, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    return sorted(totals.items(), key=lambda kv: -kv[1])


def read(prof, launches: Dict[str, int], first: int, last: int,
         host_window_s: float) -> Tuple[Optional[Profile], object]:
    """A :class:`Profile` from a finished profiler, or ``(None, shortfall)``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # the harness's own annotations also appear on the device's timeline,
    # spanning the kernels they enclose: they are no operation
    events = [e for e in prof.events() if e.name not in LABELS and not e.is_user_annotation]
    kernels = [e for e in events if e.device_type == cuda]
    if not kernels:
        return None, "no device records"
    records = {c: sum(1 for e in kernels if any(p in e.name for p in pats))
               for c, pats in COUNTED_KERNELS.items()}
    short = {c: f"{records[c]} records of {n} launches"
             for c, n in launches.items() if c in records and records[c] != n}
    if short:
        return None, short
    win = [e for e in prof.events()
           if e.name == WINDOW_LABEL and e.device_type != cuda]
    w0, w1 = ((win[0].time_range.start, win[0].time_range.end) if win else
              (min(e.time_range.start for e in kernels), max(e.time_range.end for e in kernels)))
    busy = _merge([(e.time_range.start, e.time_range.end) for e in kernels])
    busy_us = sum(min(b, w1) - max(a, w0) for a, b in busy if b > w0 and a < w1)
    by_kernel: Dict[str, List[float]] = {}
    groups: Dict[str, float] = {}
    for e in kernels:
        s = (e.time_range.end - e.time_range.start) * 1e-6
        acc = by_kernel.setdefault(e.name, [0.0, 0])
        acc[0] += s
        acc[1] += 1
        g = kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + s
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type != cuda and e.name != WINDOW_LABEL)
    window_s = (w1 - w0) * 1e-6 if win else host_window_s
    return Profile(window_s, busy_us * 1e-6, {k: (v[0], int(v[1])) for k, v in by_kernel.items()},
                   groups, launches, idle_by_host(busy, w0, w1, host), first, last), None


def profile_steps(step: Callable[[], object], n_steps: int, steps_done: Callable[[], int],
                  tries: int = 3) -> Tuple[Optional[Profile], List[object]]:
    """Profile ``n_steps`` calls of ``step`` (one engine step each), up to
    ``tries`` windows until one keeps every counted kernel's records.
    Returns the profile (None if every window fell short) and what each
    retaken window lacked."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import launch_counts

    retaken: List[object] = []
    for _ in range(tries):
        torch.cuda.synchronize()
        before = launch_counts()
        first = steps_done()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_LABEL):
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    step()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
        after = launch_counts()
        launches = {k: n - before.get(k, 0) for k, n in after.items() if n - before.get(k, 0)}
        result, short = read(prof, launches, first, steps_done(), t1 - t0)
        if result is not None:
            return result, retaken
        retaken.append(short)
    return None, retaken


def breakdown(p: Profile) -> dict:
    """The traced line's ``breakdown``: the kernels that took most device
    time, and the longest idle time by what the host was doing."""
    ops = sorted(((k, v[0]) for k, v in p.kernels.items()), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, s] for k, s in ops],
            "idle_gaps": [[k, s] for k, s in p.idle_gaps[:TOP]]}
