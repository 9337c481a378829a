"""Share of the window's wall time in which no operation ran on the
device, per decode tick: 1 minus the device's busy time a tick in the
traced slice (the union of its operations' intervals over its ticks)
over the window's wall time a tick (host clock, unprofiled). The
slice's own wall time is not the denominator: the profiler records
every host operation there and slows the host several times over,
which would read as idle device time."""


def read(rec):
    s = rec.slice
    slice_ticks = sum(d.ticks for d in rec.traced.dispatches)
    window_ticks = sum(d.ticks for d in rec.window.dispatches)
    if s is None or not s.ops or not slice_ticks or not window_ticks \
            or rec.window_s <= 0:
        return None
    busy = s.busy_s / slice_ticks
    return 100.0 * (1.0 - busy / (rec.window_s / window_ticks))
