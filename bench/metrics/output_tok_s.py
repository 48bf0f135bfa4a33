"""Tokens the clients received in the window, over the window (host clock)."""


def read(run):
    n = sum(1 for r in run.loop.requests.values() for t in r.times if run.in_window(t))
    return n / run.window_s
