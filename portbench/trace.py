"""The device trace of a slice of the run, read from ``torch.profiler``.

The harness wraps each of its calls into the program in a
``record_function`` span (``SPANS``); a slice is profiled with CPU and
CUDA activity, and reduced here to the device's operations (kernels,
copies, sets) as intervals on the trace's clock, the harness's spans on
the same clock, and what follows from them: the busy time (the union of
the operations' intervals inside the slice), the idle gaps labelled by
the span the host was in, and the time and count of the operations a
name matches.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Tuple

SUBMIT, TICK, READBACK = "portbench.submit", "portbench.tick", \
    "portbench.readback"
SPANS = (SUBMIT, TICK, READBACK)

Interval = Tuple[float, float]          # microseconds on the trace's clock


@dataclasses.dataclass
class Slice:
    ops: List[Tuple[str, float, float]]      # device operations
    spans: List[Tuple[str, float, float]]    # the harness's spans
    begin: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.begin) * 1e-6

    def busy(self) -> List[Interval]:
        return union([(max(a, self.begin), min(b, self.end))
                      for _, a, b in self.ops
                      if b > self.begin and a < self.end])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def matching(self, pattern: str) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [(b - a) for n, a, b in self.ops if rx.search(n)]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        by: dict = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps inside the slice, each labelled by
        the harness span the host was in at the gap's start."""
        out = []
        t = self.begin
        for a, b in self.busy() + [(self.end, self.end)]:
            if a > t:
                out.append((a - t, t))
            t = max(t, b)
        out.sort(reverse=True)
        return [[self.label(t0), dt * 1e-6] for dt, t0 in out[:n]]

    def label(self, t: float) -> str:
        inside = [(b - a, name) for name, a, b in self.spans if a <= t < b]
        return min(inside)[1].split(".")[-1] if inside else "harness"


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def profile(fn: Callable[[], None], sync: Callable[[], None]) -> \
        Optional[Slice]:
    """Run ``fn`` under the profiler and reduce its trace; None when the
    trace holds none of the harness's spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile
    sync()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    ops, spans = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if ev.name in SPANS:        # the spans' projection on the device
                continue
            ops.append((ev.name, float(tr.start), float(tr.end)))
        elif ev.name in SPANS:
            spans.append((ev.name, float(tr.start), float(tr.end)))
    if not spans:
        return None
    return Slice(ops=ops, spans=spans, begin=min(a for _, a, _ in spans),
                 end=max(b for _, _, b in spans))
