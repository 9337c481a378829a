"""Tracing / profiling instrumentation.

Counterpart of the reference's ``utils/profiling.py`` on torch.profiler:

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity where a card is present) that writes a
  trace of every op and device kernel run inside under ``logdir``, in the
  format of TensorBoard's profiler plugin
  (``tensorboard_trace_handler``). ``ANT_TPU_PROFILE=<dir>`` with
  ``maybe_trace(profile_dir_from_env())`` turns it on.
- ``annotate(name)``: named region (``record_function``; a band in the
  trace viewer).
- ``StepTimer``: wall-clock per-step statistics with a device fence. CUDA
  launches return before the device has run them, so a step's time is
  only right once the host waits for the device
  (``torch.cuda.synchronize``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["trace", "annotate", "StepTimer", "maybe_trace", "fence",
           "profile_dir_from_env"]


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
    """trace() when a directory is given (CLI --profile plumbing),
    else a no-op."""
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
    """ANT_TPU_PROFILE=<dir> turns tracing on for bench/CLIs."""
    return os.environ.get("ANT_TPU_PROFILE") or None
