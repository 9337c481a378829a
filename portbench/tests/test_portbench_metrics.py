"""The metric readers' arithmetic on hand-made records: a rate over the
whole window, and percentiles over every sample, which move when a
stall is put into the window."""

from __future__ import annotations

import pytest

from portbench import harness, spec, stats, trace

ROOT = spec.root_of()


def _record(gaps, ttft, tokens, t_open=10.0, t_close=40.0):
    cell = spec.cell("opt-6.7b.longgen", ROOT)
    rec = harness.Record(cell=cell, lm=cell.config["lm"], slots=32)
    rec.t_open, rec.t_close = t_open, t_close
    rec.window.gaps = list(gaps)
    rec.window.ttft = list(ttft)
    rec.window.tokens = tokens
    return rec


def _read(rec, name):
    return rec.cell.reader(name)(rec)


def test_percentile_is_linear_between_order_statistics():
    xs = list(range(1, 101))                       # 1..100
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 90) == pytest.approx(90.1)
    assert stats.percentile(xs, 99) == pytest.approx(99.01)
    assert stats.percentile([], 90) is None


def test_rate_is_over_the_whole_window():
    rec = _record([0.05] * 10, [0.4] * 10, tokens=6000)
    assert _read(rec, "output_tokens_per_s") == pytest.approx(200.0)
    # the same tokens over a window that also held a 3 s stall
    rec.t_close += 3.0
    assert _read(rec, "output_tokens_per_s") == pytest.approx(6000 / 33)


def test_tails_move_when_a_stall_enters_the_window():
    gaps = [0.050] * 2000
    ttft = [0.300] * 150
    rec = _record(gaps, ttft, 6000)
    assert _read(rec, "itl_p99_ms") == pytest.approx(50.0)
    assert _read(rec, "ttft_p90_ms") == pytest.approx(300.0)
    # a 2 s stall holds every one of 32 slots' next token and 20 callers'
    # first tokens: 32 gaps of 2 s and 20 first tokens 2 s late
    stalled = _record(gaps + [2.0] * 32, ttft + [2.3] * 20, 6000)
    assert _read(stalled, "itl_p99_ms") > 1000.0
    assert _read(stalled, "ttft_p90_ms") > 2000.0


def test_tick_and_prefill_times_are_window_totals():
    rec = _record([], [], 0)
    rec.window.dispatches = [harness.Dispatch(0.0, 0.05, 1, [[1]]),
                             harness.Dispatch(1.0, 1.15, 1, [[2]])]
    assert _read(rec, "decode_tick_ms") == pytest.approx(100.0)
    rec.window.submits = [(0.0, 0.2, 500), (1.0, 1.3, 1500)]
    assert _read(rec, "prefill_ms_per_ktok") == pytest.approx(250.0)
    rec.window.forwards = [(1, 512, 384), (32, 1, 1), (1, 1024, 640)]
    assert _read(rec, "prefill_pad_pct") == pytest.approx(
        100 * (1536 - 1024) / 1536)


def test_device_readers_need_a_trace():
    rec = _record([], [], 0)
    for name in ("k1_roofline", "k2_decode_roofline", "device_idle_pct"):
        assert _read(rec, name) is None


def _slice(ops):
    return trace.Slice(ops=ops, spans=[(trace.TICK, 0.0, 1000.0)],
                       begin=0.0, end=1000.0)


def test_idle_share_and_gaps_from_the_trace():
    s = _slice([("a", 0.0, 100.0), ("b", 50.0, 200.0), ("c", 600.0, 700.0)])
    assert s.busy_s == pytest.approx(300e-6)
    assert s.gaps(2) == [["tick", pytest.approx(400e-6)],
                         ["tick", pytest.approx(300e-6)]]
    # the window: 10 ticks in 10 ms of host time, 1 ms a tick; the
    # slice: 0.3 ms of device time in its one tick, however long the
    # profiled host took over it
    rec = _record([], [], 0, t_open=0.0, t_close=0.01)
    rec.window.dispatches = [harness.Dispatch(0.0, 0.01, 10, [[1]] * 10)]
    rec.traced.dispatches = [harness.Dispatch(0.0, 1.0, 1, [[11]])]
    rec.slice = s
    assert _read(rec, "device_idle_pct") == pytest.approx(70.0)
    rec.slice = trace.Slice(ops=s.ops, spans=s.spans, begin=0.0,
                            end=5000.0)
    assert _read(rec, "device_idle_pct") == pytest.approx(70.0)


def test_k1_roofline_scales_lost_events():
    """A decode forward of 32 rows launches K1 six times a layer; a trace
    that lost half of the events is scaled back to all of them."""
    from portbench import counts
    rec = _record([], [], 0)
    rec.traced.forwards = [(32, 1, 1)]
    n, byts, ops = counts.k1_forward(rec.lm, 32)
    per = 1e6 * counts.bound_s(byts, ops) / n * 2    # at half the bound
    ops_all = [("void (anonymous namespace)::i8_stream_kernel<4>(...)",
                i * 1000.0, i * 1000.0 + per) for i in range(n)]
    rec.slice = _slice(ops_all)
    assert _read(rec, "k1_roofline") == pytest.approx(50.0)
    rec.slice = _slice(ops_all[::2])
    assert _read(rec, "k1_roofline") == pytest.approx(50.0)


def test_k2_decode_roofline_counts_serving_slots_only():
    from portbench import counts
    rec = _record([], [], 0)
    L = rec.lm["n_layers"]
    rec.traced.dispatches = [harness.Dispatch(0, 1, 1, [[99, 499]])]
    byts, ops = counts.k2_decode_layer(rec.lm, [99, 499])
    t = counts.bound_s(byts, 0, ops) * 1e6           # one layer at its bound
    ops_l = []
    for i in range(L):
        ops_l += [("void split_kernel<128, 1, true>(...)", 10.0 * i,
                   10.0 * i + t * 0.8),
                  ("void combine_kernel<128>(...)", 10.0 * i + 5,
                   10.0 * i + 5 + t * 0.2)]
    rec.slice = _slice(ops_l)
    assert _read(rec, "k2_decode_roofline") == pytest.approx(100.0)


def test_window_mfu_counts_forwards_from_shapes():
    from portbench import counts
    rec = _record([], [], 0, t_open=0.0, t_close=2.0)
    rec.window.dispatches = [harness.Dispatch(0, 1, 1, [[10, 20]])]
    rec.window.submits = [(0, 1, 700)]
    want = (counts.decode_forward_s(rec.lm, [10, 20])
            + counts.prefill_forward_s(rec.lm, 700)) / 2.0 * 100
    assert _read(rec, "window_mfu_pct") == pytest.approx(want)
