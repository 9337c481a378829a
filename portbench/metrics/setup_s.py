"""Seconds from the process's start to the window's first tick: the
build or its cache, the weights, the cache, warming the cell's shapes,
the first submissions and the warm-up dispatches."""


def read(rec):
    return rec.setup_s
