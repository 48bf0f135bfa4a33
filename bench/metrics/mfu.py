"""The window's counted model FLOPs over the window and the H100's bf16
peak, in percent: every prompt token prefilled and every token decoded in
the window's steps (2 x the parameters it multiplies, plus QK^T and P.V
over the rows it attends)."""

from harness import work


def read(run):
    m = run.model
    flops = sum(sum(work.prefill_flops(m, t) for t in s.prefills)
                + sum(work.decode_flops(m, rows) for rows in s.tick_rows)
                for s in run.window_steps())
    return 100.0 * flops / run.window_s / work.PEAK_FLOPS
