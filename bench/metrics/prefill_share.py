"""Percent of the window the engine spent in its ``serve.prefill`` spans."""


def read(run):
    if run.spans is None:
        return None
    busy = sum(min(end, run.t_close) - max(start, run.t_open)
               for name, start, end, _ in run.spans
               if name == "serve.prefill" and end > run.t_open and start < run.t_close)
    return 100.0 * busy / run.window_s
