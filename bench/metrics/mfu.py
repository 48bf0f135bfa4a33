"""The window's counted model FLOPs over the window and the H100's bf16
peak, in percent: every prompt token prefilled and every token decoded in
the window's steps, as the configuration's reference module counts them
(for attention plus an MLP: 2 x the parameters a token multiplies, plus
QK^T and P.V over the rows it attends)."""

from harness import work


def read(run):
    m, arch = run.model, run.arch
    flops = sum(sum(arch.prefill_flops(m, t) for t in s.prefills)
                + sum(arch.decode_flops(m, rows) for rows in s.tick_rows)
                for s in run.window_steps())
    return 100.0 * flops / run.window_s / work.PEAK_FLOPS
