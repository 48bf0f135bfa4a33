"""The exact 90th percentile of the engine's ``serve.queue_wait`` spans that
ended in the window, in ms: a request's stint in the pending queue, from
its submit (or preemption) to its admission, on the engine's clock."""

import numpy as np


def read(run):
    spans = run.window_spans("serve.queue_wait") if run.spans is not None else []
    waits = [end - start for _, start, end, _ in spans]
    return float(np.percentile(waits, 90)) * 1e3 if waits else None
