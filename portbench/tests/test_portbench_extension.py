"""A configuration, a cell and a per-layer metric are added as new files
and entries only: on a copy of the benchmark, the harness finds and
runs them, and no file that was there changes."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

import portbench_tiny as pt
from portbench import harness, report, spec

METRIC = '''"""Ticks run in the window."""


def read(rec):
    return float(sum(d.ticks for d in rec.window.dispatches))
'''


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    root = tmp_path / "bench"
    root.mkdir()
    shutil.copy(pt.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(pt.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_files_and_entries_only(copy):
    before = _digest(copy)
    pkg = copy / "portbench"
    cfg = pt.tiny_config("opt-6.7b-ant-w4a4")
    cfg["name"] = "opt-tiny-ant-w4a4"
    (pkg / "configs" / "opt-tiny-ant-w4a4.json").write_text(json.dumps(cfg))
    mix = pt.tiny_mix("docqa")
    (pkg / "traffic" / "tinyqa.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "ticks_run.py").write_text(METRIC)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "opt-tiny-ant-w4a4", "source": "https://example.org/tiny",
        "file": "portbench/configs/opt-tiny-ant-w4a4.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "opt-tiny.tinyqa", "config": "opt-tiny-ant-w4a4",
        "traffic": "tinyqa", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "ticks_run", "unit": "ticks", "better": "higher",
        "source": "host_clock", "layer": "serve/scheduler.py",
        "moves": "output_tokens_per_s", "workloads": ["opt-tiny.tinyqa"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("opt-tiny.tinyqa", copy)
    assert cell.config["name"] == "opt-tiny-ant-w4a4"
    assert cell.mix == mix
    assert [m["name"] for m in cell.per_layer][-1] == "ticks_run"
    assert "ticks_run" not in [m["name"] for m in spec.cell(
        "opt-6.7b.longgen", copy).per_layer]
    torch.manual_seed(0)
    rec, verdict = harness.run(cell, 9, 0.5, True, "cpu")
    got = report.metrics(rec, cell.per_layer)
    assert got["ticks_run"]["value"] == len(rec.window.dispatches)
    after = _digest(copy)
    changed = [k for k in before if before[k] != after.get(k)]
    assert changed == ["BENCHMARK.json"]
    assert set(after) - set(before) == {
        "portbench/configs/opt-tiny-ant-w4a4.json",
        "portbench/traffic/tinyqa.json", "portbench/metrics/ticks_run.py"}
