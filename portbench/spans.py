"""The program's own spans and counters, read for the per-layer metrics.

The port records them on the host clock (``time.perf_counter_ns``) in
``utils/profiling.py`` while a ``torch.profiler`` session records, so the
traced slice gets them with no edit to the harness. A span is ``(name,
start_ns, end_ns, parent, key)``, ``parent`` the index of the innermost
span open at its start; a counter event is ``(name, n, t_ns, parent)``.

- Selection: the records that lie between the first traced dispatch's
  ``t0`` and the last one's ``t1`` (``rec.traced.dispatches``, read on
  ``time.perf_counter``, the records' clock).
- Decode work: every span under a ``batcher.dispatch`` except the
  subtree of a ``batcher.prefill``, and the counter events under such
  spans. "A tick" is the decode work of the slice's dispatches over the
  slice's ticks.
- Self time: a span's duration less its child spans' durations.
- The clock mapping: each traced dispatch runs inside one harness
  ``portbench.tick`` span, and its ``t0`` is read just inside it, its
  ``t1`` just before the span closes. The offset is the median over the
  dispatches of ``span.start_us - t0 * 1e6``. A span's end lies later
  than ``t1`` by the time the profiler takes to close it (60-110 us on
  the H100's host, in every tick and submit span alike; the starts
  agree within 20 us): that lag is the median over the dispatches of
  ``span.end_us - t1 * 1e6 - offset``. The residual is the largest
  deviation from the offset at the starts, and from the offset plus the
  lag at the ends. Past ``MAX_RESIDUAL_US`` the mapping is refused.
  With it, each device-idle stretch of the slice goes to the innermost
  program span the host was in.

Every reader returns None where the program has no recorder or recorded
nothing in the slice, as a program without these spans does.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Tuple

from . import trace

DISPATCH, PREFILL = "batcher.dispatch", "batcher.prefill"
SYNC, KV_APPEND = "host.sync", "kv.append"
LAUNCH, FORWARD = "kernel.launch", "engine.forward"
KV_COPIES = "kv.copies"
MAX_RESIDUAL_US = 50.0
OUTSIDE = "harness"             # idle time outside every program span

Interval = Tuple[float, float]


def recorded() -> Optional[Tuple[list, list]]:
    """(spans, counter events) the program kept, or None when it has no
    recorder or kept nothing."""
    try:
        from ant_quantization_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    counts = getattr(profiling, "counts", None)
    if records is None or counts is None:
        return None
    spans = records()
    return (spans, counts()) if spans else None


def _inside(spans: list, lo_ns: float, hi_ns: float) -> List[int]:
    return [i for i, (_, s, e, _, _) in enumerate(spans)
            if e is not None and s >= lo_ns and e <= hi_ns]


def _kinds(spans: list) -> List[Optional[str]]:
    """"decode" for decode work, "prefill" for a prefill's subtree, else
    None (parents come before their children)."""
    kinds: List[Optional[str]] = []
    for name, _, _, parent, _ in spans:
        up = kinds[parent] if parent is not None else None
        if name == PREFILL or up == "prefill":
            kinds.append("prefill")
        elif name == DISPATCH or up == "decode":
            kinds.append("decode")
        else:
            kinds.append(None)
    return kinds


@dataclasses.dataclass
class Decode:
    """The decode work of one phase's dispatches, by span name."""
    ticks: int
    n: Dict[str, int]           # spans
    total_ns: Dict[str, int]    # their durations
    self_ns: Dict[str, int]     # their self times
    counts: Dict[str, int]      # counter events' sums
    dispatch_ns: int            # the outermost dispatches, less prefills
    kv_self: List[Interval]     # kv.append self intervals, in ns

    def self_ms(self, name: str) -> float:
        """Self time a tick, ms."""
        return self.self_ns.get(name, 0) * 1e-6 / self.ticks

    def total_ms(self, name: str) -> float:
        """Time a tick inside the spans, ms."""
        return self.total_ns.get(name, 0) * 1e-6 / self.ticks

    def per_tick(self, name: str) -> float:
        """Spans, or a counter's sum, a tick."""
        return (self.counts[name] if name in self.counts
                else self.n.get(name, 0)) / self.ticks


def _self_intervals(spans: list, idx: List[int],
                    kids: Dict[int, List[int]]) -> Dict[int, List[Interval]]:
    """Each span's interval less its children's."""
    out = {}
    for i in idx:
        t, s_i = spans[i][1], []
        for c in kids.get(i, ()):
            if spans[c][1] > t:
                s_i.append((t, spans[c][1]))
            t = max(t, spans[c][2])
        if spans[i][2] > t:
            s_i.append((t, spans[i][2]))
        out[i] = s_i
    return out


def _children(spans: list, idx: List[int]) -> Dict[int, List[int]]:
    kids: Dict[int, List[int]] = {}
    for i in idx:
        p = spans[i][3]
        if p is not None:
            kids.setdefault(p, []).append(i)
    return kids


def decode(rec, phase=None) -> Optional[Decode]:
    """The decode work of ``phase``'s dispatches (the traced slice by
    default), or None without records there."""
    phase = rec.traced if phase is None else phase
    got = recorded()
    ds = phase.dispatches
    ticks = sum(d.ticks for d in ds)
    if got is None or not ticks:
        return None
    spans, events = got
    idx = _inside(spans, ds[0].t0 * 1e9, ds[-1].t1 * 1e9)
    kinds = _kinds(spans)
    work = [i for i in idx if kinds[i] == "decode"]
    if not work:
        return None
    kids = _children(spans, idx)
    d = Decode(ticks=ticks, n={}, total_ns={}, self_ns={}, counts={},
               dispatch_ns=0, kv_self=[])
    for i in work:
        name, s, e, parent, _ = spans[i]
        dur = e - s
        d.n[name] = d.n.get(name, 0) + 1
        d.total_ns[name] = d.total_ns.get(name, 0) + dur
        d.self_ns[name] = d.self_ns.get(name, 0) + dur - sum(
            spans[c][2] - spans[c][1] for c in kids.get(i, ()))
        if parent is None or kinds[parent] != "decode":
            d.dispatch_ns += dur - sum(
                spans[c][2] - spans[c][1] for c in _subtree(i, kids)
                if kinds[c] == "prefill" and kinds[spans[c][3]] == "decode")
    chosen = set(work)
    for name, n, _, parent in events:
        if parent in chosen:
            d.counts[name] = d.counts.get(name, 0) + n
    kv = [i for i in work if spans[i][0] == KV_APPEND]
    d.kv_self = sorted(iv for ivs in _self_intervals(spans, kv, kids).values()
                       for iv in ivs)
    return d


def _subtree(i: int, kids: Dict[int, List[int]]) -> List[int]:
    out, todo = [], list(kids.get(i, ()))
    while todo:
        c = todo.pop()
        out.append(c)
        todo.extend(kids.get(c, ()))
    return out


# ---- the clock mapping --------------------------------------------------

def clock(rec) -> Optional[Tuple[float, float, float]]:
    """(offset, residual, lag) in microseconds: a host time of ``t``
    seconds sits at ``t * 1e6 + offset`` on the trace's clock; ``lag`` is
    the ends' median lag behind ``t1``. None without a trace, or when its
    tick spans do not pair with the dispatches."""
    s, ds = rec.slice, rec.traced.dispatches
    if s is None or not ds:
        return None
    ticks = sorted((a, b) for name, a, b in s.spans if name == trace.TICK)
    if len(ticks) != len(ds):
        return None
    starts = [a - d.t0 * 1e6 for (a, _), d in zip(ticks, ds)]
    ends = [b - d.t1 * 1e6 for (_, b), d in zip(ticks, ds)]
    offset = statistics.median(starts)
    lag = statistics.median(ends) - offset
    residual = max(max(abs(a - offset) for a in starts),
                   max(abs(b - offset - lag) for b in ends))
    return offset, residual, lag


def offset(rec) -> Optional[float]:
    """The clock mapping's offset, or None when it is refused."""
    c = clock(rec)
    return c[0] if c is not None and c[1] <= MAX_RESIDUAL_US else None


def idle(s: trace.Slice) -> List[Interval]:
    """The slice's device-idle stretches on the trace's clock, in order."""
    out, t = [], s.begin
    for a, b in s.busy() + [(s.end, s.end)]:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    return out


def overlap(xs: List[Interval], ys: list) -> Dict[object, float]:
    """The overlap of ``xs`` with each label's intervals in ``ys``: two
    ordered lists of disjoint intervals, ``ys`` as ``(start, end,
    label)``."""
    i = j = 0
    out: Dict[object, float] = {}
    while i < len(xs) and j < len(ys):
        (a, b), (c, e, label) = xs[i], ys[j]
        lo, hi = max(a, c), min(b, e)
        if hi > lo:
            out[label] = out.get(label, 0.0) + hi - lo
        if b < e:
            i += 1
        else:
            j += 1
    return out


def kv_append_idle_ms(rec) -> Optional[float]:
    """Device-idle time a tick inside ``kv.append``'s self time."""
    d, off = decode(rec), offset(rec)
    if d is None or off is None:
        return None
    kv = [(a * 1e-3 + off, b * 1e-3 + off, KV_APPEND) for a, b in d.kv_self]
    return overlap(idle(rec.slice), kv).get(KV_APPEND, 0.0) * 1e-3 / d.ticks


def idle_by_span(rec) -> Optional[Dict[str, float]]:
    """The slice's device-idle seconds by the innermost program span the
    host was in (``OUTSIDE`` where it was in none), or None without the
    mapping."""
    got, off = recorded(), offset(rec)
    if got is None or off is None:
        return None
    s = rec.slice
    spans = got[0]
    idx = _inside(spans, (s.begin - off) * 1e3, (s.end - off) * 1e3)
    own = _self_intervals(spans, idx, _children(spans, idx))
    marks = sorted((a * 1e-3 + off, b * 1e-3 + off, spans[i][0])
                   for i, ivs in own.items() for a, b in ivs)
    gaps = idle(s)
    out = {name: us * 1e-6 for name, us in overlap(gaps, marks).items()}
    out[OUTSIDE] = sum(b - a for a, b in gaps) * 1e-6 - sum(out.values())
    return out


def gap_spans(rec, n: int = 10) -> Optional[List[list]]:
    """The ``n`` longest idle gaps of the slice as ``[harness label,
    seconds, innermost program span at the gap's start]``, or None
    without the mapping."""
    got, off = recorded(), offset(rec)
    if got is None or off is None:
        return None
    spans = got[0]
    s = rec.slice
    idx = _inside(spans, (s.begin - off) * 1e3, (s.end - off) * 1e3)
    out = []
    for a, b in sorted(idle(s), key=lambda iv: iv[0] - iv[1])[:n]:
        t = (a - off) * 1e3
        inner = [(spans[i][1], spans[i][0]) for i in idx
                 if spans[i][1] <= t < spans[i][2]]
        out.append([s.label(a), (b - a) * 1e-6,
                    max(inner)[1] if inner else OUTSIDE])
    return out
