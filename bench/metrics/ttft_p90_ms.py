"""The exact 90th percentile of the time from a client's submit to its
request's first token, over the requests whose first token came in the
window and those submitted and still waiting when it closed (counted at
their wait so far), host clock, in ms."""

import numpy as np


def read(run):
    waits = []
    for r in run.loop.requests.values():
        first = r.times[0] if r.times else None
        if first is not None and run.in_window(first):
            waits.append(first - r.submit_t)
        elif r.submit_t <= run.t_close and (first is None or first > run.t_close):
            waits.append(run.t_close - r.submit_t)
    return float(np.percentile(waits, 90)) * 1e3 if waits else None
