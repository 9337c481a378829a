"""Tiny configurations and mixes of the benchmark's cells, for the CPU
tests: the same families, routes and loop at a size the CPU runs in
seconds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"

TINY_LM = {"d_model": 64, "n_layers": 2, "n_heads": 2, "d_ff": 128,
           "vocab_size": 512, "max_seq": 256}
TINY_MIX = {"clients": 4, "slots": 4, "prompt_tokens": [8, 40],
            "output_tokens": [4, 12], "buckets": [16, 32, 48],
            "warmup_dispatches": 1, "trace_dispatches": 2,
            "check_tokens": 40}


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(load(PKG / "configs" / f"{name}.json"))
    cfg["lm"].update(TINY_LM)
    cfg["engine"]["max_seq"] = TINY_LM["max_seq"]
    return cfg


def tiny_mix(name: str) -> dict:
    mix = copy.deepcopy(load(PKG / "traffic" / f"{name}.json"))
    mix.update(TINY_MIX)
    return mix


def tiny_cell(cell_name: str, limit=None):
    """The cell ``cell_name`` of BENCHMARK.json at the tiny size."""
    from portbench import spec
    c = spec.cell(cell_name, ROOT)
    bench = spec.benchmark(ROOT)
    w = next(x for x in bench["workloads"] if x["name"] == cell_name)
    c.config = tiny_config(w["config"])
    c.mix = tiny_mix(w["traffic"])
    c.limits = {} if limit is None else {"mean_gap": {"limit": limit}}
    return c
