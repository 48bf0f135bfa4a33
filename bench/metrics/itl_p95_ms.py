"""The exact 95th percentile of every gap between consecutive tokens of a
request, the later token received in the window (host clock), in ms."""

import numpy as np


def read(run):
    gaps = [b - a for r in run.loop.requests.values()
            for a, b in zip(r.times, r.times[1:]) if run.in_window(b)]
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
