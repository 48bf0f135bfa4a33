"""flash_star's share of its roofline over the prefills of the profiled
steps, in percent: the least time their attention needs (causal QK^T and
P.V at the bf16 peak, or Q, K, V and the output moved once; the
configuration's reference module's count), over the device time of the
flash_star kernels."""


def read(run):
    p = run.profile
    if p is None or p.group_s("flash_star") <= 0:
        return None
    steps = run.loop.steps[p.first_step:p.last_step]
    least = sum(run.arch.flash_least_s(run.model, t) for s in steps for t in s.prefills)
    return 100.0 * least / p.group_s("flash_star") if least > 0 else None
