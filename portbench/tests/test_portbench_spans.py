"""The readers of the program's spans (``portbench/spans.py`` and the
seven metrics on it): on hand-made records and a hand-made slice, the
clock mapping's offset and residual and its refusal past 50 us, self
times, decode work without prefills, and device-idle time inside
``kv.append``; on a tiny CPU run of each cell, a number from each
reader; without the program's recorder, None from each."""

from __future__ import annotations

import pytest
import torch

import portbench_tiny as pt
from portbench import harness, spans, spec, trace

ROOT = spec.root_of()
NEW = ("host_wait_ms", "host_syncs_per_tick", "kv_append_host_ms",
       "kv_copies_per_tick", "kernel_launch_host_ms", "forward_host_ms",
       "kv_append_idle_ms")
OFF = 250.0                     # trace us = host s * 1e6 + OFF
DISPATCHES = (1000, 2000, 3000)  # ms
MS = 1_000_000                  # ns


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(rec, name):
    return rec.cell.reader(name)(rec)


class Spans:
    """Records in the program's form, built by nesting."""

    def __init__(self):
        self.spans, self.events, self.open = [], [], []

    def add(self, name, start_ms, end_ms, key=None, kids=()):
        i = len(self.spans)
        self.spans.append((name, int(start_ms * MS), int(end_ms * MS),
                           self.open[-1] if self.open else None, key))
        self.open.append(i)
        for kid in kids:
            kid(self)
        self.open.pop()
        return i


def span(name, a, b, *kids, key=None):
    return lambda s: s.add(name, a, b, key, kids)


def counter(name, n):
    return lambda s: s.events.append((name, n, 0, s.open[-1]))


def tick(t, key):
    """A tick of 10 ms from ``t`` ms: a forward with one kv.append of
    4 ms (1 ms of it a host.sync) holding 8 copies, one launch of 2 ms."""
    return span("batcher.tick", t, t + 10, span(
        "engine.forward", t + 1, t + 9,
        span("kv.append", t + 2, t + 6, span("host.sync", t + 3, t + 4),
             counter("kv.copies", 8)),
        span("kernel.launch", t + 6, t + 8)), key=key)


def dispatch(t):
    """A dispatch of 30 ms from ``t`` ms: two ticks and, between them, a
    prefill of 5 ms whose own kv.append is no decode work."""
    return span("batcher.dispatch", t, t + 30,
                span("host.sync", t, t + 1), tick(t + 2, 0),
                span("batcher.prefill", t + 13, t + 18,
                     span("kv.append", t + 14, t + 17)),
                tick(t + 19, 1))


def _record(monkeypatch, end_shift=0.0, ops=(), start_shift=0.0):
    """Three traced dispatches at 1000, 2000 and 3000 ms of host time,
    inside harness tick spans that start 3 us (less ``start_shift`` on
    the second) before ``t0`` and end 84 us (plus ``end_shift`` on the
    second) after ``t1``, as the profiler closes a span late."""
    s = Spans()
    for t in DISPATCHES:
        s.add("batcher.submit", t - 40, t - 20)      # outside any dispatch
        dispatch(t)(s)
    monkeypatch.setattr(spans, "recorded", lambda: (s.spans, s.events))
    cell = spec.cell("opt-6.7b.longgen", ROOT)
    rec = harness.Record(cell=cell, lm=cell.config["lm"], slots=64)
    rec.traced.dispatches = [
        harness.Dispatch(t / 1e3 - 1e-6, (t + 31) / 1e3, 2, [[1], [2]])
        for t in DISPATCHES]
    ticks = []
    for i, d in enumerate(rec.traced.dispatches):
        ticks.append((trace.TICK,
                      d.t0 * 1e6 + OFF - 3 - (start_shift if i == 1 else 0),
                      d.t1 * 1e6 + OFF + 84 + (end_shift if i == 1 else 0)))
    rec.slice = trace.Slice(ops=list(ops), spans=ticks,
                            begin=ticks[0][1], end=ticks[-1][2])
    return rec


def test_clock_offset_residual_and_lag(monkeypatch):
    rec = _record(monkeypatch, start_shift=5.0, end_shift=-7.0)
    off, res, lag = spans.clock(rec)
    assert off == pytest.approx(OFF - 3)
    assert lag == pytest.approx(3 + 84)
    assert res == pytest.approx(7.0)
    assert spans.offset(rec) == pytest.approx(OFF - 3)


@pytest.mark.parametrize("where", ["start", "end"])
def test_clock_refused_past_50_us(monkeypatch, where):
    kw = lambda us: {f"{where}_shift": us}
    ok = _record(monkeypatch, **kw(50.0))
    assert spans.clock(ok)[1] == pytest.approx(50.0, abs=1e-6)
    assert _read(ok, "kv_append_idle_ms") is not None
    bad = _record(monkeypatch, **kw(51.0))
    assert spans.clock(bad)[1] > spans.MAX_RESIDUAL_US
    assert spans.offset(bad) is None
    assert _read(bad, "kv_append_idle_ms") is None
    # the host-clock readers need no mapping
    assert _read(bad, "kv_append_host_ms") == pytest.approx(3.0)


def test_self_times_and_counts_of_decode_work(monkeypatch):
    rec = _record(monkeypatch)
    d = spans.decode(rec)
    assert d.ticks == 6
    # per tick: a kv.append of 4 ms less its 1 ms sync; the dispatch's
    # own sync of 1 ms a dispatch (two ticks) adds 0.5 ms a tick
    assert _read(rec, "kv_append_host_ms") == pytest.approx(3.0)
    assert _read(rec, "host_wait_ms") == pytest.approx(1.0 + 0.5)
    assert _read(rec, "host_syncs_per_tick") == pytest.approx(1.5)
    assert _read(rec, "kv_copies_per_tick") == pytest.approx(8.0)
    assert _read(rec, "kernel_launch_host_ms") == pytest.approx(2.0)
    assert _read(rec, "forward_host_ms") == pytest.approx(8.0 - 4 - 2)
    # the self times sum to the dispatches less their prefills
    assert d.dispatch_ns == 3 * (30 - 5) * MS
    assert sum(d.self_ns.values()) == d.dispatch_ns
    assert "batcher.prefill" not in d.n and d.n["kv.append"] == 6


def _host_us(ms):
    return ms * 1e3 + OFF - 3


def test_idle_inside_kv_append(monkeypatch):
    # kv.append's self time in the first tick: 1004-1005 and 1006-1008
    # ms; the device is busy 1004.5-1006.5 there, and all the time at
    # every other kv.append and at the prefill's
    busy = [("k", _host_us(1004.5), _host_us(1006.5))]
    for t in DISPATCHES:
        for a in (t + 21, t + 14) + ((t + 4,) if t > 1000 else ()):
            busy.append(("k", _host_us(a), _host_us(a + 4.0)))
    rec = _record(monkeypatch, ops=busy)
    # idle inside: 0.5 ms before the busy stretch, 1.5 ms after it
    assert _read(rec, "kv_append_idle_ms") == pytest.approx(2.0 / 6)
    by = spans.idle_by_span(rec)
    assert by["kv.append"] == pytest.approx(2.0e-3)
    total = sum(b - a for a, b in spans.idle(rec.slice)) * 1e-6
    assert sum(by.values()) == pytest.approx(total)
    # the longest gaps: from 1025 and 2025 ms (the launch after a
    # dispatch's last kv.append) to the next dispatch's first busy
    # stretch, then 1006.5-1014 ms in the first kv.append
    gaps = spans.gap_spans(rec, 3)
    for g in gaps[:2]:
        assert g == ["tick", pytest.approx(0.979), "kernel.launch"]
    assert gaps[2] == ["tick", pytest.approx(7.5e-3), "kv.append"]


@pytest.fixture(scope="module")
def tiny_runs():
    """One traced run of each cell at the tiny size, on the CPU."""
    out = {}
    for w in spec.benchmark(pt.ROOT)["workloads"]:
        cell = pt.tiny_cell(w["name"], limit=10.0)
        out[w["name"]] = harness.run(cell, 2 ** 31 + 5, 0.3, True, "cpu")[0]
    return out


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_a_tiny_cpu_run(tiny_runs, name, monkeypatch):
    for cell, rec in tiny_runs.items():
        if name == "kv_append_idle_ms" and \
                spans.clock(rec)[1] > spans.MAX_RESIDUAL_US:
            # a CPU's profiler may take longer than that to open and
            # close the harness's span: the mapping is refused, and read
            # here without its bound
            assert _read(rec, name) is None
            monkeypatch.setattr(spans, "MAX_RESIDUAL_US", float("inf"))
        v = _read(rec, name)
        assert isinstance(v, float) and v >= 0.0, (cell, v)
        if name == "kv_append_idle_ms":
            # no device operation on the CPU: kv.append's self time is
            # idle throughout
            assert v == pytest.approx(_read(rec, "kv_append_host_ms"))


def test_tiny_run_counts(tiny_runs):
    for rec in tiny_runs.values():
        L = rec.cell.config["lm"]["n_layers"]
        slots = rec.cell.mix["slots"]
        assert _read(rec, "kv_copies_per_tick") == 4 * slots * L
        d = spans.decode(rec)
        host = sum(x.t1 - x.t0 for x in rec.traced.dispatches) * 1e9
        assert sum(d.self_ns.values()) == d.dispatch_ns <= host


@pytest.mark.parametrize("name", NEW)
def test_readers_without_the_recorder_read_none(tiny_runs, name,
                                                monkeypatch):
    from ant_quantization_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "records")
    for rec in tiny_runs.values():
        assert _read(rec, name) is None
