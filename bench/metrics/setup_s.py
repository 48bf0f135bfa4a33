"""Seconds from the process's start to the window's opening: imports, the
weights, the engine, the first wave's prefills and the warm-up steps that
capture the decode tick's graph."""


def read(run):
    return run.setup_s
