"""The paged decode kernels' share of their roofline over the profiled
steps, in percent: the least time the ticks' paged attention needs (each
live K/V row, query and output moved once at the HBM's 3.35 TB/s, or its
FLOPs at the bf16 peak; the configuration's reference module's count), over
the device time of the paged kernels."""


def read(run):
    p = run.profile
    if p is None or p.group_s("paged_attention") <= 0:
        return None
    steps = run.loop.steps[p.first_step:p.last_step]
    least = sum(run.arch.paged_least_s(run.model, s.tick_rows) for s in steps if s.tick_rows)
    return 100.0 * least / p.group_s("paged_attention")
