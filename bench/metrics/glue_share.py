"""Percent of the profiled device time in copy / cast and other kernels
(neither a GEMM nor one of the port's kernels nor the MoE's sort)."""


def read(run):
    p = run.profile
    if p is None:
        return None
    total = sum(p.groups.values())
    return 100.0 * p.group_s("copy/cast", "other") / total if total > 0 else None
