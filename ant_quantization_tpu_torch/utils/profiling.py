"""Tracing / profiling instrumentation.

Counterpart of the reference's ``utils/profiling.py`` on torch.profiler:

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present) that writes a
  trace of every op and device kernel run inside under ``logdir``, in the
  format of TensorBoard's profiler plugin
  (``tensorboard_trace_handler``). ``maybe_trace(logdir)`` is ``trace``
  when given a directory and nothing without one; with
  ``maybe_trace(profile_dir_from_env())`` the operator's own code turns
  it on by setting ``ANT_TPU_PROFILE=<dir>``.
- ``annotate(name)``: named region (``record_function``; a band in the
  trace viewer).
- ``StepTimer``: wall-clock per-step statistics with a device fence. CUDA
  launches return before the device has run them, so a step's time is
  only right once the host waits for the device
  (``torch.cuda.synchronize``).

The program's own spans and counters, on the host clock:

- ``span(name, key=None)`` marks a stretch of host work and ``count(name,
  n)`` adds ``n`` under the innermost open span. They record only while
  recording is on: inside ``recording()``, the operator's switch, or
  while a ``torch.profiler`` session records. Otherwise ``span`` returns
  one shared null context after a single flag check, with no allocation
  and no clock read.
- A span's record is ``(name, start_ns, end_ns, parent, key)`` on
  ``time.perf_counter_ns``: ``parent`` is the index in ``records()`` of
  the innermost span open at its start (None at the top), ``key`` what
  the caller gave (the serving path gives the absolute tick of a tick
  and the request id of a prefill). A counter event is ``(name, n,
  t_ns, parent)``. The buffers hold the newest ``MAX_RECORDS`` spans and
  counter events each; ``dropped()`` counts the older ones let go.
- ``records()`` and ``counts()`` return what was recorded without
  emptying it; ``clear()`` empties it.

The spans are not ``record_function``: under ``torch.profiler`` such a
range also shows up as a device-side user annotation, which a reader of
the device trace takes for a device operation as long as the whole
range, so a span around a forward would count its idle gaps as busy.
The records stay in this module's buffers, and a reader maps them onto
the trace's clock itself.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "annotate", "StepTimer", "maybe_trace", "fence",
           "profile_dir_from_env", "span", "count", "recording", "records",
           "counts", "dropped", "clear", "MAX_RECORDS"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a host and device trace into ``logdir`` (TensorBoard
    format: ``<worker>.<time>.pt.trace.json``). The device is fenced
    before the capture stops, so every kernel launched inside is in it."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield logdir
        finally:
            if cuda:
                torch.cuda.synchronize()


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str]):
    """trace() when a directory is given, else a no-op."""
    if not logdir:
        yield None
        return
    with trace(logdir):
        yield logdir


def annotate(name: str):
    """Named trace region: ``with annotate('prefill'): ...``"""
    return torch.profiler.record_function(name)


def _first_tensor(x) -> Optional[torch.Tensor]:
    """The first tensor leaf of a dict/list/tuple tree, dicts in sorted
    key order (the reference's leaf order)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = [x[k] for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def fence(x) -> None:
    """Block until the device of ``x``'s first tensor leaf has run
    everything queued on it (nothing to wait for on the CPU)."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Per-step wall-clock stats around a step function.

        timer = StepTimer()
        for batch in data:
            with timer.step():
                out = train_step(params, batch)
            timer.fence(out)      # optional: fold sync into the step
        print(timer.summary())
    """

    def __init__(self):
        self.times: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield self
        self.times.append(time.perf_counter() - t0)

    def fence(self, x) -> None:
        """Device fence attributed to the *previous* step."""
        t0 = time.perf_counter()
        fence(x)
        if self.times:
            self.times[-1] += time.perf_counter() - t0

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        ts = self.times[skip_warmup:] if len(self.times) > skip_warmup \
            else self.times
        if not ts:
            return {"steps": 0}
        arr = np.asarray(ts)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }


def profile_dir_from_env() -> Optional[str]:
    """The directory ``ANT_TPU_PROFILE`` names, for ``maybe_trace`` in the
    operator's own code; None when it is unset or empty."""
    return os.environ.get("ANT_TPU_PROFILE") or None


# ---- the program's spans and counters --------------------------------

MAX_RECORDS = 1 << 19       # spans kept, and counter events kept

SpanRecord = Tuple[str, int, Optional[int], Optional[int], Optional[Hashable]]
CountRecord = Tuple[str, int, int, Optional[int]]


class _Recorder:
    """The buffers: spans as ``[name, start, end, parent, key]`` lists
    (``end`` None while open), ``parent`` an absolute index (spans opened
    before it, however many were dropped or cleared since)."""

    def __init__(self, maxlen: int = MAX_RECORDS):
        self.on = 0                 # depth of recording() blocks
        self.spans = collections.deque(maxlen=maxlen)
        self.events = collections.deque(maxlen=maxlen)
        self.opened = 0             # spans ever opened
        self.first = 0              # absolute index of spans[0]
        self.dropped = [0, 0]       # spans, counter events let go
        self.stack: List[int] = []  # absolute indices of the open spans


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "key", "rec")

    def __init__(self, name: str, key):
        self.name, self.key = name, key

    def __enter__(self):
        r = _REC
        self.rec = [self.name, time.perf_counter_ns(), None,
                    r.stack[-1] if r.stack else None, self.key]
        if len(r.spans) == r.spans.maxlen:
            r.first += 1
            r.dropped[0] += 1
        r.spans.append(self.rec)
        r.stack.append(r.opened)
        r.opened += 1
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        _REC.stack.pop()
        return False


_NULL = contextlib.nullcontext()


def span(name: str, key: Optional[Hashable] = None):
    """``with span("engine.forward"): ...``: one record while recording
    is on, else the shared null context."""
    if not (_REC.on or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, key)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` under the innermost open span, while
    recording is on."""
    r = _REC
    if not (r.on or _autograd_profiler._is_profiler_enabled):
        return
    if len(r.events) == r.events.maxlen:
        r.dropped[1] += 1
    r.events.append((name, int(n), time.perf_counter_ns(),
                     r.stack[-1] if r.stack else None))


@contextlib.contextmanager
def recording():
    """Record the program's spans and counters inside the block, with or
    without a profiler (blocks nest)."""
    _REC.on += 1
    try:
        yield
    finally:
        _REC.on -= 1


def _relative(parent: Optional[int]) -> Optional[int]:
    first = _REC.first
    return parent - first if parent is not None and parent >= first \
        else None


def records() -> List[SpanRecord]:
    """The spans kept, oldest first: ``(name, start_ns, end_ns, parent,
    key)``, ``parent`` an index into this list (None at the top, or when
    the parent is no longer kept), ``end_ns`` None while the span is
    open."""
    return [(n, s, e, _relative(p), k) for n, s, e, p, k in _REC.spans]


def counts() -> List[CountRecord]:
    """The counter events kept, oldest first: ``(name, n, t_ns,
    parent)``, ``parent`` an index into ``records()``."""
    return [(n, c, t, _relative(p)) for n, c, t, p in _REC.events]


def dropped() -> Tuple[int, int]:
    """(spans, counter events) let go to keep the newest
    ``MAX_RECORDS`` of each."""
    return tuple(_REC.dropped)


def clear() -> None:
    """Empty the buffers and the dropped counts. Spans open now close as
    usual but are not kept."""
    _REC.spans.clear()
    _REC.events.clear()
    _REC.first = _REC.opened
    _REC.dropped = [0, 0]
