"""Architecture-optimization sweep: the experiments/ capability.

The reference's bitfusion/src/experiments/architecture_optimization.py
sweeps the area split between the systolic array and the three scratchpad
buffers under a fixed area budget (CACTI SRAM area + synthesized per-PE
area from results/systolic_array_synth.csv), simulates the benchmark list
for every candidate, and reports the best-performing configuration;
ideal_benefits_variable_precision.py compares fixed- vs variable-precision
arrays on the same sweep. Rebuilt here on our analytic models:

  * SRAM area          perfmodel/sram.py:sram_area_mm2 (csrc fit)
  * systolic PE area   pe_area_mm2: bit-serial multiplier area scales with
                       the pmax x pmin bit product (anchored at an 8x8-bit
                       MAC + register ~= 2400 um^2 @ 45 nm, the scale of
                       the reference's synth CSV rows)
  * cycles             perfmodel/simulator.Simulator over perfmodel/nets

A candidate = (n, m, sram_act, sram_wgt, sram_out). The sweep enumerates
power-of-two arrays and buffer splits, keeps candidates within the area
budget, and ranks by mean benchmark cycles (ties: less area).

Counterpart of the reference's ``perfmodel/arch.py``; ``device`` is where
the tiling search runs (the card by default).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

from .energy import energy_params
from .model import AcceleratorConfig
from .nets import get_layers
from .simulator import Simulator
from .sram import sram_area_mm2

# 8x8 multiplier + accumulator + pipeline register at 45 nm
_PE_AREA_8x8_MM2 = 2400e-6
_PE_FIXED_MM2 = 400e-6          # per-PE control/register overhead


def pe_area_mm2(pmax: int, pmin: int) -> float:
    """Per-PE area: multiplier area ~ bit-product, plus fixed overhead.
    A fusion-style decomposable PE (pmin < pmax) pays a ~12% muxing tax
    per halving level (BitFusion's reported overhead scale)."""
    mult = _PE_AREA_8x8_MM2 * (pmax * pmax) / 64.0
    levels = 0
    p = pmax
    while p > pmin:
        p //= 2
        levels += 1
    return (mult * (1.0 + 0.12 * levels)) + _PE_FIXED_MM2


def array_area_mm2(cfg: AcceleratorConfig) -> float:
    return cfg.n * cfg.m * pe_area_mm2(cfg.pmax, cfg.pmin)


def buffer_area_mm2(cfg: AcceleratorConfig) -> float:
    """Scratchpads are banked per systolic row/col like the reference's
    CACTI sweep (per-bank size = total / banks; act+out dual-ported)."""
    act = cfg.n * sram_area_mm2(cfg.sram_act / cfg.n, 64, 1)
    out = cfg.m * sram_area_mm2(cfg.sram_out / cfg.m, 64, 1)
    wgt = cfg.m * sram_area_mm2(cfg.sram_wgt / cfg.m, 64, 0)
    return act + out + wgt


def total_area_mm2(cfg: AcceleratorConfig) -> float:
    return array_area_mm2(cfg) + buffer_area_mm2(cfg)


@dataclasses.dataclass
class ArchPoint:
    cfg: AcceleratorConfig
    area_mm2: float
    mean_cycles: float
    mean_energy_nj: float

    @property
    def edp(self) -> float:
        return self.mean_cycles * self.mean_energy_nj


def candidates(area_budget_mm2: float,
               arrays: Optional[Sequence[tuple]] = None,
               sram_kb: Sequence[int] = (32, 64, 128, 256, 512),
               pmax: int = 8, pmin: int = 4) -> List[AcceleratorConfig]:
    """Power-of-two geometry/buffer grid, filtered to the area budget."""
    arrays = arrays or [(n, n) for n in (8, 16, 32, 64)]
    out = []
    for n, m in arrays:
        for a in sram_kb:
            for w in sram_kb:
                for o in sram_kb:
                    cfg = AcceleratorConfig(
                        n=n, m=m, pmax=pmax, pmin=pmin,
                        sram_act=a * 1024, sram_wgt=w * 1024,
                        sram_out=o * 1024)
                    if total_area_mm2(cfg) <= area_budget_mm2:
                        out.append(cfg)
    return out


def evaluate(cfg: AcceleratorConfig, nets: Sequence[str],
             table: str = "ant", batch: int = 16,
             device=None) -> ArchPoint:
    sim = Simulator(cfg, device=device)
    cycles, energy = [], []
    for net in nets:
        st = sim.network(get_layers(net, table), batch, False)
        cycles.append(st.total_cycles)
        energy.append(st.energy(energy_params(cfg)))
    k = len(nets)
    return ArchPoint(cfg, total_area_mm2(cfg),
                     sum(cycles) / k, sum(energy) / k)


def sweep(area_budget_mm2: float, nets: Sequence[str],
          table: str = "ant", batch: int = 16,
          arrays: Optional[Sequence[tuple]] = None,
          sram_kb: Sequence[int] = (32, 64, 128, 256, 512),
          pmax: int = 8, pmin: int = 4, rank: str = "cycles",
          device=None) -> List[ArchPoint]:
    """All in-budget candidates evaluated, best first."""
    pts = [evaluate(c, nets, table, batch, device)
           for c in candidates(area_budget_mm2, arrays, sram_kb, pmax, pmin)]
    key = {"cycles": lambda p: (p.mean_cycles, p.area_mm2),
           "energy": lambda p: (p.mean_energy_nj, p.area_mm2),
           "edp": lambda p: (p.edp, p.area_mm2)}[rank]
    return sorted(pts, key=key)


def variable_precision_benefit(cfg: AcceleratorConfig, nets: Sequence[str],
                               table: str = "ant", batch: int = 16,
                               device=None) -> dict:
    """ideal_benefits_variable_precision.py: same geometry, fixed pmax-only
    array vs the decomposable (pmin) array, on the same precision tables."""
    fixed = dataclasses.replace(cfg, pmin=cfg.pmax)
    var = evaluate(cfg, nets, table, batch, device)
    fix = evaluate(fixed, nets, table, batch, device)
    return {
        "variable": var, "fixed": fix,
        "speedup": fix.mean_cycles / var.mean_cycles,
        "area_overhead": var.area_mm2 / fix.area_mm2,
    }
