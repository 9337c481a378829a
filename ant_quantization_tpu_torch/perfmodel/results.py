"""Benchmark results: the run_ant.py equivalent.

Sweeps the 6 accelerator configurations over the 8-net benchlist at batch
64, normalizes cycles and the 4-way energy breakdown against AdaFloat, and
writes a tidy CSV (one row per network x accelerator) plus the reference's
summary line layout (ant_simulator/run_ant.py:39-459; golden output
ant_simulator/results/ant_res.csv).

Accelerator column mapping (run_ant.py config blocks):
  ant_os   conf_ant geometry, ANT precision tables, output-stationary
  ant_ws   conf_ant geometry, ANT tables, weight-stationary
  bitfusion conf_ant geometry, BitFusion precision tables
  olaccel  16x18 geometry, OLAccel tables
  adafloat 32x28 geometry, all-8-bit (the =1.00 baseline)
  biscaled 32x80 6-bit geometry (reported for vgg16/resnet50 only, but
           simulated on all nets, feeding the mean like the reference)

Note the reference's "Geomean" column is an arithmetic mean (run_ant.py
sums then divides); reproduced as-is.

Counterpart of the reference's ``perfmodel/results.py``; ``device`` is
where the tiling search runs (the card by default).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

from .energy import CONFIGS, energy_params
from .model import LayerStats
from .nets import BENCHLIST
from .nets import get_layers
from .simulator import Simulator

ACCELS = ["ant_os", "ant_ws", "bitfusion", "olaccel", "adafloat", "biscaled"]

_SETUP = {
    # accel key -> (geometry config name, table name, weight_stationary)
    "ant_os": ("ant", "ant", False),
    "ant_ws": ("ant", "ant_weight", True),
    "bitfusion": ("ant", "bitfusion", False),
    "olaccel": ("olaccel", "olaccel", False),
    "adafloat": ("adafloat", "adafloat", False),
    "biscaled": ("biscaled", "biscaled", False),
}


def sweep(batch: int = 64, nets: Optional[List[str]] = None,
          device=None) -> Dict[str, Dict[str, LayerStats]]:
    """accel -> net -> summed LayerStats."""
    nets = nets or BENCHLIST
    out: Dict[str, Dict[str, LayerStats]] = {}
    for accel in ACCELS:
        geom, table, ws = _SETUP[accel]
        sim = Simulator.named(geom, device=device)
        out[accel] = {
            net: sim.network(get_layers(net, table), batch, ws)
            for net in nets}
    return out


def normalized_results(batch: int = 64, nets: Optional[List[str]] = None,
                       device=None) -> List[dict]:
    """Tidy rows: one per (network, accel) with cycles normalized to
    AdaFloat and the energy breakdown as fractions of AdaFloat's total."""
    nets = nets or BENCHLIST
    stats = sweep(batch, nets, device)
    rows = []
    for net in nets:
        base = stats["adafloat"][net]
        e_base = base.energy_breakdown(energy_params(CONFIGS["adafloat"]))
        e_total = sum(e_base)
        for accel in ACCELS:
            geom, _, _ = _SETUP[accel]
            st = stats[accel][net]
            static, dram, sram, core = st.energy_breakdown(
                energy_params(CONFIGS[geom]))
            rows.append({
                "network": net, "accel": accel,
                "cycles": st.total_cycles,
                "norm_cycles": st.total_cycles / base.total_cycles,
                "static": static / e_total, "dram": dram / e_total,
                "sram": sram / e_total, "core": core / e_total,
                "norm_energy": (static + dram + sram + core) / e_total,
            })
    return rows


def summarize(rows: List[dict]) -> Dict[str, Dict[str, float]]:
    """accel -> {'cycles': mean norm cycles, 'energy': mean norm energy}
    (arithmetic mean over networks, as in run_ant.py's 'Geomean')."""
    out: Dict[str, Dict[str, float]] = {}
    for accel in ACCELS:
        sel = [r for r in rows if r["accel"] == accel]
        out[accel] = {
            "cycles": sum(r["norm_cycles"] for r in sel) / len(sel),
            "energy": sum(r["norm_energy"] for r in sel) / len(sel),
        }
    return out


def write_csv(rows: List[dict], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def format_summary(rows: List[dict]) -> str:
    """The reference's headline line: normalized cycles per accelerator
    (ANT-OS, ANT-WS, BitFusion, OLAccel, BiScaled, AdaFloat)."""
    s = summarize(rows)
    order = ["ant_os", "ant_ws", "bitfusion", "olaccel", "biscaled",
             "adafloat"]
    names = ["ANT-OS", "ANT-WS", "BitFusion", "OLAccel", "BiScaled",
             "AdaFloat"]
    lines = ["accel      norm_cycles  norm_energy"]
    for k, n in zip(order, names):
        lines.append(f"{n:<10} {s[k]['cycles']:>11.2f}  "
                     f"{s[k]['energy']:>11.2f}")
    return "\n".join(lines)
