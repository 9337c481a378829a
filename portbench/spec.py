"""The benchmark's data, each piece found by its name.

``BENCHMARK.json`` names the cells; a cell names its configuration (a
file under ``configs/``) and its traffic mix (``traffic/<name>.json``),
which names its generator (``traffic/<generator>.py``); a metric is read
by ``metrics/<name>.py``; a configuration's ``family`` names its plain
reference (``reference/<family>.py``); a cell's limits are in
``limits/<cell>.json``. A later change adds a configuration, a cell or a
metric by adding such files and entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PKG = Path(__file__).resolve().parent


def root_of(pkg: Path = PKG) -> Path:
    return pkg.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def module(path: Path) -> ModuleType:
    """A benchmark file loaded as a module by its path (once per path)."""
    key = "portbench_file_" + hashlib.sha1(
        str(path.resolve()).encode()).hexdigest()[:16]
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    """A metric is reported in the cells its ``workloads`` lists, or in
    every cell without one."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict                 # the configuration file
    mix: dict                    # the traffic mix file
    end_to_end: List[dict]       # BENCHMARK.json entries that apply
    per_layer: List[dict]
    limits: dict                 # number compared -> {"limit": ...}
    pkg: Path = PKG

    def generator(self) -> ModuleType:
        return module(self.pkg / "traffic" / f"{self.mix['generator']}.py")

    def reference(self) -> ModuleType:
        return module(self.pkg / "reference" / f"{self.config['family']}.py")

    def reader(self, metric: str):
        return module(self.pkg / "metrics" / f"{metric}.py").read


def cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` under ``root``, with
    its files from the benchmark's own folder there."""
    root = Path(root) if root is not None else root_of()
    bench = benchmark(root)
    pkg = root / bench["paths"][0]
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}"
                       f" (known: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    mix = load_json(pkg / "traffic" / f"{w['traffic']}.json")
    limits_path = pkg / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name=name, chips=int(w["chips"]), config=cfg, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)],
                limits=limits, pkg=pkg)
