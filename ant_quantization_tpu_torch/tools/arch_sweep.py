"""Architecture-optimization CLI (src/experiments/ equivalent).

Counterpart of the reference's ``tools/arch_sweep.py``, with its flags
plus ``--device``: sweeps systolic-array geometry and scratchpad splits
under an area budget and reports the best configurations, like the
reference's architecture_optimization.py; --variable-precision instead
reports the fixed-vs-decomposable array comparison of
ideal_benefits_variable_precision.py. The tiling search runs on
``--device``: the card by default (it raises without one), or
``--device cpu``.

    python -m ant_quantization_tpu_torch.tools.arch_sweep --budget 3.5 \\
        --nets vgg16 resnet18
    python -m ant_quantization_tpu_torch.tools.arch_sweep --budget 3.5 \\
        --rank edp --out sweep.csv
    python -m ant_quantization_tpu_torch.tools.arch_sweep \\
        --variable-precision --nets vgg16 --device cpu
"""

from __future__ import annotations

import argparse
import csv

from ..perfmodel import arch
from ..perfmodel.energy import CONFIGS
from ..perfmodel.nets import BENCHLIST

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--budget", type=float, default=3.5,
                   help="area budget, mm^2 (reference default: 3.5)")
    p.add_argument("--nets", nargs="*", default=["vgg16", "resnet18"],
                   choices=BENCHLIST)
    p.add_argument("--table", default="ant",
                   help="precision-table family (ant/bitfusion/...)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--rank", default="cycles",
                   choices=("cycles", "energy", "edp"))
    p.add_argument("--sram-kb", nargs="*", type=int,
                   default=[32, 64, 128, 256])
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--out", default=None, help="write full sweep CSV")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tiling search")
    p.add_argument("--variable-precision", action="store_true",
                   help="report fixed- vs variable-precision array benefit "
                        "for the ANT geometry instead of sweeping")
    args = p.parse_args(argv)

    if args.variable_precision:
        r = arch.variable_precision_benefit(
            CONFIGS["ant"], args.nets, args.table, args.batch,
            device=args.device)
        print(f"variable-precision speedup: {r['speedup']:.2f}x "
              f"(area overhead {r['area_overhead']:.2f}x)")
        print(f"  variable: {r['variable'].mean_cycles:.0f} cycles, "
              f"{r['variable'].area_mm2:.2f} mm^2")
        print(f"  fixed   : {r['fixed'].mean_cycles:.0f} cycles, "
              f"{r['fixed'].area_mm2:.2f} mm^2")
        return

    pts = arch.sweep(args.budget, args.nets, args.table, args.batch,
                     sram_kb=args.sram_kb, rank=args.rank,
                     device=args.device)
    if not pts:
        print("no configuration fits the area budget")
        return
    print(f"{len(pts)} configurations within {args.budget} mm^2; "
          f"top {min(args.top, len(pts))} by {args.rank}:")
    print(f"{'array':>8} {'act/wgt/out KB':>16} {'area':>7} "
          f"{'Mcycles':>9} {'energy uJ':>10}")
    for pt in pts[:args.top]:
        c = pt.cfg
        print(f"{c.n:>3}x{c.m:<4} "
              f"{c.sram_act // 1024:>5}/{c.sram_wgt // 1024}/"
              f"{c.sram_out // 1024:<5} {pt.area_mm2:>7.2f} "
              f"{pt.mean_cycles / 1e6:>9.2f} "
              f"{pt.mean_energy_nj / 1e3:>10.1f}")
    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["n", "m", "sram_act", "sram_wgt", "sram_out",
                        "area_mm2", "mean_cycles", "mean_energy_nj"])
            for pt in pts:
                c = pt.cfg
                w.writerow([c.n, c.m, c.sram_act, c.sram_wgt, c.sram_out,
                            pt.area_mm2, pt.mean_cycles, pt.mean_energy_nj])
        print(f"wrote {len(pts)} rows to {args.out}")


if __name__ == "__main__":
    main()
