"""Host time of every ``step`` / ``step_chunk`` in the window, over the
ticks they ran."""


def read(rec):
    ds = rec.window.dispatches
    ticks = sum(d.ticks for d in ds)
    return sum(d.t1 - d.t0 for d in ds) * 1e3 / ticks if ticks else None
