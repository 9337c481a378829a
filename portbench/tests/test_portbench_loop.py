"""The harness's loop on the CPU, at a tiny preset of every cell: the
window, the traced slice, the check and the result line. The command
itself refuses to run without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import portbench_tiny as pt
from portbench import harness, report, spec

CELLS = [w["name"] for w in spec.benchmark(pt.ROOT)["workloads"]]
CARD_ONLY = {"peak_mem_gib"}          # read from the card's allocator


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_reports_the_end_to_end_metrics(name):
    cell = pt.tiny_cell(name, limit=10.0)
    rec, verdict = harness.run(cell, 2 ** 31 + 17, 1.0, False, "cpu")
    line = report.line(rec, verdict, False)
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    want = {m["name"] for m in cell.end_to_end} - CARD_ONLY
    assert set(line["metrics"]) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= cell.mix["clients"]
    assert rec.window.tokens > 0 and rec.window_s >= 1.0
    assert verdict["requests"] > 0 and verdict["tokens"] > 0
    # every prefill bucket the mix uses is in the check's sample
    assert verdict["buckets"] == sorted(cell.mix["buckets"])
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_host_side_layer_metrics(name):
    cell = pt.tiny_cell(name, limit=10.0)
    rec, verdict = harness.run(cell, 5, 0.5, True, "cpu")
    line = report.line(rec, verdict, True)
    got = set(line["metrics"])
    assert got <= {m["name"] for m in cell.per_layer}
    assert {"decode_tick_ms", "window_mfu_pct"} <= got
    # the CPU has no device trace: nothing of the device is reported
    assert not got & {"k1_roofline", "k2_decode_roofline",
                      "device_idle_pct"}
    assert rec.slice is not None and rec.traced.dispatches
    assert line["device"]["busy_s"] == 0.0


def test_limit_decides_correct():
    cell = pt.tiny_cell("opt-6.7b.longgen", limit=-1.0)
    _, verdict = harness.run(cell, 3, 0.5, False, "cpu")
    assert verdict["correct"] is False
    cell.limits = {}
    _, verdict = harness.run(cell, 3, 0.5, False, "cpu")
    assert verdict["correct"] is False and verdict["limit"] is None


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without")
    out = subprocess.run(
        [sys.executable, str(pt.PKG / "run.py"), "--workload",
         "opt-6.7b.longgen", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=pt.ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr
