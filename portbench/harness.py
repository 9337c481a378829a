"""One run of one cell: set-up, the measured window, the traced slice,
the check against the plain reference, and the result line.

The program under test is the port's serving layer: a
``ContinuousBatcher`` (``serve/scheduler.py``) over ``engine.forward``.
The window drives it only through ``submit`` and ``step`` /
``step_chunk``, with ``clients`` closed-loop callers: when a dispatch
returns a finished request, its caller submits its next one at once
(``submit`` prefills it and returns once its first token is on the
host). Each token counts when the call that delivers it returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import check, trace, weights
from .spec import Cell

now = time.perf_counter


@dataclasses.dataclass
class Dispatch:
    t0: float
    t1: float
    ticks: int
    # per tick, the write positions of the slots that serve a request
    positions: List[List[int]]


@dataclasses.dataclass
class Phase:
    """What the harness saw in one stretch of the run (the window, or the
    traced slice after it)."""
    dispatches: List[Dispatch] = dataclasses.field(default_factory=list)
    # (t0, t1, real prompt tokens) of every submit
    submits: List[Tuple[float, float, int]] = dataclasses.field(
        default_factory=list)
    tokens: int = 0
    ttft: List[float] = dataclasses.field(default_factory=list)
    gaps: List[float] = dataclasses.field(default_factory=list)
    # (batch, positions given, real positions) of each forward call,
    # with --trace 1
    forwards: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    attempted: int = 0


@dataclasses.dataclass
class Record:
    """Everything the metric readers take their numbers from."""
    cell: Cell
    lm: dict
    slots: int
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    t_open: float = 0.0
    t_close: float = 0.0
    window: Phase = dataclasses.field(default_factory=Phase)
    traced: Phase = dataclasses.field(default_factory=Phase)
    slice: Optional[trace.Slice] = None
    memory_peak_bytes: int = 0
    # the engine routes forwards of at most this many rows to K1
    k1_max_m: int = 64

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def engine_config(config: dict):
    """The port's ``EngineConfig`` of a configuration file; the
    implementation's own settings stay at the program's defaults."""
    from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
    from ant_quantization_tpu_torch.serve.engine import EngineConfig
    e = dict(config["engine"])
    e["dtype"] = weights.dtype_of(e["dtype"])
    return EngineConfig(lm=LMConfig(**config["lm"]), **e)


class Loop:
    """The closed loop over one batcher."""

    def __init__(self, batcher, stream, rec: Record, ticks: int,
                 spans: bool):
        self.b = batcher
        self.stream = stream
        self.rec = rec
        self.ticks = ticks
        self.spans = spans
        # each request in flight: when its caller last received a token
        self.last_t: Dict[int, float] = {}
        self.done: List[tuple] = []          # finished in window or slice
        self.phase: Optional[Phase] = None   # None during set-up

    def span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def submit(self, prompt: List[int], max_new: int, t_sent: float) -> None:
        from ant_quantization_tpu_torch.serve.scheduler import Request
        with self.span(trace.SUBMIT):
            t0 = now()
            rid = self.b.submit(Request(prompt=prompt,
                                        max_new_tokens=max_new))
            t1 = now()
        self.last_t[rid] = t1
        ph = self.phase
        if ph is not None:
            ph.submits.append((t0, t1, len(prompt)))
            ph.ttft.append(t1 - t_sent)
            ph.tokens += 1
            ph.attempted += 1

    def dispatch(self) -> None:
        b = self.b
        pre = {}
        for s, r in enumerate(b.slot_req):
            if r is not None:
                pre[s] = (r.id, len(b.slot_tokens[s]), int(b.lengths[s]),
                          r.max_new_tokens)
        positions = [[p + i for rid, n, p, mx in pre.values() if i < mx - n]
                     for i in range(self.ticks)]
        with self.span(trace.TICK):
            t0 = now()
            finished = b.step() if self.ticks == 1 else \
                b.step_chunk(self.ticks)
            t1 = now()
        with self.span(trace.READBACK):
            ph = self.phase
            by_id = {c.id: c for c in finished}
            for s, (rid, n, _, _) in pre.items():
                have = (len(by_id[rid].tokens) if rid in by_id
                        else len(b.slot_tokens[s]))
                self.received(rid, have - n, t1)
            if ph is not None:
                ph.dispatches.append(Dispatch(t0, t1, self.ticks, positions))
            for c in finished:
                del self.last_t[c.id]
                if ph is not None:
                    self.done.append((list(c.prompt), list(c.tokens)))
                prompt, max_new = self.stream.next()
                self.submit(prompt, max_new, t1)

    def received(self, rid: int, new: int, t: float) -> None:
        """``new`` tokens of request ``rid`` reached its caller at ``t``;
        a gap counts when both its ends lie in the window or slice."""
        if new <= 0:
            return
        ph = self.phase
        if ph is not None:
            ph.tokens += new
            if self.last_t[rid] >= self.rec.t_open:
                ph.gaps.append(t - self.last_t[rid])
                ph.gaps.extend([0.0] * (new - 1))
        self.last_t[rid] = t

    def open(self, phase: Phase) -> None:
        self.phase = phase
        phase.attempted += sum(r is not None for r in self.b.slot_req)


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: Optional[float] = None,
        control: bool = False) -> tuple:
    """One run of ``cell`` on ``device``: set-up, the window of
    ``seconds``, with ``traced`` the profiled slice after it, then the
    check (with ``control``, the control's reading beside it). Returns
    ``(record, verdict)``."""
    from ant_quantization_tpu_torch import _ext
    from ant_quantization_tpu_torch.serve import engine as eng
    from ant_quantization_tpu_torch.serve.scheduler import ContinuousBatcher

    t_start = now() if t_start is None else t_start
    dev = torch.device(device)
    sync = _sync(dev)
    cfg = engine_config(cell.config)
    mix = cell.mix
    rec = Record(cell=cell, lm=cell.config["lm"], slots=int(mix["slots"]),
                 k1_max_m=cfg.stacked_max_m)
    parts = rec.setup_parts
    t = now()

    def part(name: str) -> None:
        nonlocal t
        sync()
        parts[name] = now() - t
        t = now()

    parts["start"] = t - t_start
    if dev.type == "cuda":
        _ext.build_all()
        torch.cuda.reset_peak_memory_stats(dev)
    part("build")
    ep = weights.make(cell.config, seed, dev)
    part("weights")

    rec_forwards: Optional[list] = None

    def forward(ep_, ids, kv, pos0, last_index=None):
        if rec_forwards is not None:
            B, T = ids.shape
            rec_forwards.append((B, T, T if last_index is None
                                 else int(last_index) + 1))
        return eng.forward(cfg, ep_, ids, kv, pos0, last_index=last_index)

    buckets = tuple(int(x) for x in mix["buckets"])
    batcher = ContinuousBatcher(cfg, ep, rec.slots, prefill_buckets=buckets,
                                forward_fn=forward if traced else None)
    part("cache")
    with torch.no_grad():               # every bucket's prefill shapes
        kv1 = eng.init_cache(cfg, 1, device=dev)
        zero = torch.zeros((1,), dtype=torch.int32)
        for Tb in buckets:
            ids = torch.zeros((1, Tb), dtype=torch.int64, device=dev)
            eng.forward(cfg, ep, ids, kv1, zero, last_index=Tb - 1)
        del kv1, ids
    part("warm_buckets")
    stream = cell.generator().make(mix, cfg.lm.vocab_size, seed)
    loop = Loop(batcher, stream, rec, int(mix["ticks_per_dispatch"]),
                spans=traced)
    t_sent = now()
    for prompt, max_new in stream.first_requests():
        loop.submit(prompt, max_new, t_sent)
    part("submissions")
    for _ in range(int(mix["warmup_dispatches"])):
        loop.dispatch()
    part("warm_ticks")

    rec.t_open = now()
    rec.setup_s = rec.t_open - t_start
    rec_forwards = rec.window.forwards if traced else None
    loop.open(rec.window)
    while True:
        loop.dispatch()
        if now() - rec.t_open >= seconds:
            break
    rec.t_close = now()
    sync()
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if traced:
        rec_forwards = rec.traced.forwards
        loop.open(rec.traced)
        rec.slice = trace.profile(
            lambda: [loop.dispatch()
                     for _ in range(int(mix["trace_dispatches"]))], sync)
    loop.phase = None
    done = loop.done
    del loop, batcher, forward
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = now()
    verdict = check.judge(cell, ep, done, seed, dev, control)
    verdict["seconds"] = now() - t_check
    return rec, verdict
