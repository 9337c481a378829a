"""Paper-figure plotting for simulator results (graph_plot equivalent).

Counterpart of the reference's ``tools/plot_results.py``. The reference
ships grouped/stacked bar-chart helpers used to render the MICRO'22
figures from simulator output (ant_simulator/bitfusion/graph_plot/
barchart.py, stackedbarchart.py; consumed together with
results/ant_res.csv and the ANT-simulator.xlsx template). This tool
rebuilds that capability on the tidy CSV written by ``simulate``:

  figure "cycles" — grouped bars of cycles normalized to AdaFloat, one
      group per network plus the mean column (Figure 13 layout).
  figure "energy" — per-network stacked bars (Static/DRAM/Buffer/Core as
      fractions of AdaFloat's total energy), one stack per accelerator
      (Figure 14 layout; golden rows 7-10 of ant_res.csv).

    python -m ant_quantization_tpu_torch.tools.simulate \
        --out results/ant_res.csv
    python -m ant_quantization_tpu_torch.tools.plot_results \
        results/ant_res.csv --out results/

Headless by construction (Agg backend); emits PNG and PDF. It needs
matplotlib, which is imported when a figure is drawn (not with the
module, so the package imports where matplotlib is absent) and raises a
clear error where it is missing.
"""

from __future__ import annotations

import argparse
import csv
import os

from ..perfmodel.results import ACCELS

__all__ = ["ACCEL_LABELS", "ENERGY_PARTS", "ENERGY_LABELS", "read_rows",
           "plot_cycles", "plot_energy", "main"]

ACCEL_LABELS = {
    "ant_os": "ANT-OS", "ant_ws": "ANT-WS", "bitfusion": "BitFusion",
    "olaccel": "OLAccel", "adafloat": "AdaFloat", "biscaled": "BiScaled",
}
# grayscale ramp like the reference's COLOR_MIN..COLOR_MAX interpolation
# (graph_plot/barchart.py); light-to-dark across the accelerator series.
ENERGY_PARTS = ("static", "dram", "sram", "core")
ENERGY_LABELS = ("Static", "DRAM", "Buffer", "Core")


def _pyplot():
    """matplotlib's pyplot on the Agg backend; raises where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError(
            "plot_results needs matplotlib, which is not installed here; "
            "copy the CSV of simulate to a machine that has it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def read_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        for k in ("cycles", "norm_cycles", "norm_energy") + ENERGY_PARTS:
            if k in r:
                r[k] = float(r[k])
    return rows


def _series_color(i, n):
    t = i / max(n - 1, 1)
    lo, hi = (13 / 255, 31 / 255, 60 / 255), (0.92, 0.94, 0.97)
    return tuple(lo[c] + (hi[c] - lo[c]) * (1 - t) for c in range(3))


def _nets(rows):
    seen = []
    for r in rows:
        if r["network"] not in seen:
            seen.append(r["network"])
    return seen


def _value(rows, net, accel, key):
    for r in rows:
        if r["network"] == net and r["accel"] == accel:
            return r[key]
    raise KeyError((net, accel, key))


def plot_cycles(rows, out_base, accels=None):
    """Grouped bars: cycles normalized to AdaFloat, + mean group."""
    plt = _pyplot()
    accels = accels or ACCELS
    nets = _nets(rows)
    groups = nets + ["Mean"]
    fig, ax = plt.subplots(figsize=(11.5, 3.5))
    bw = 0.8 / len(accels)
    for i, accel in enumerate(accels):
        vals = [_value(rows, net, accel, "norm_cycles") for net in nets]
        vals.append(sum(vals) / len(vals))
        xs = [g + i * bw for g in range(len(groups))]
        ax.bar(xs, vals, width=bw, label=ACCEL_LABELS.get(accel, accel),
               color=_series_color(i, len(accels)), edgecolor="black",
               linewidth=0.4)
    ax.set_xticks([g + bw * (len(accels) - 1) / 2 for g in range(len(groups))])
    ax.set_xticklabels(groups, fontsize=9)
    ax.set_ylabel("Normalized cycles (AdaFloat = 1.0)")
    ax.axhline(1.0, color="gray", linewidth=0.6, linestyle="--")
    ax.legend(ncol=len(accels), fontsize=8, frameon=False, loc="upper left")
    fig.tight_layout()
    paths = [out_base + ext for ext in (".png", ".pdf")]
    for p in paths:
        fig.savefig(p, dpi=150)
    plt.close(fig)
    return paths


def plot_energy(rows, out_base, accels=None):
    """Per-network stacked Static/DRAM/Buffer/Core bars per accelerator."""
    plt = _pyplot()
    accels = accels or ACCELS
    nets = _nets(rows)
    fig, ax = plt.subplots(figsize=(11.5, 3.5))
    bw = 0.8 / len(accels)
    hatches = ("", "//", "..", "xx")
    for i, accel in enumerate(accels):
        xs = [g + i * bw for g in range(len(nets))]
        bottom = [0.0] * len(nets)
        for j, (part, lbl) in enumerate(zip(ENERGY_PARTS, ENERGY_LABELS)):
            vals = [_value(rows, net, accel, part) for net in nets]
            ax.bar(xs, vals, width=bw, bottom=bottom,
                   color=_series_color(j, len(ENERGY_PARTS)),
                   hatch=hatches[j], edgecolor="black", linewidth=0.3,
                   label=lbl if i == 0 else None)
            bottom = [b + v for b, v in zip(bottom, vals)]
    ax.set_xticks([g + bw * (len(accels) - 1) / 2 for g in range(len(nets))])
    ax.set_xticklabels(nets, fontsize=9)
    ax.set_ylabel("Normalized energy (AdaFloat = 1.0)")
    ax.legend(ncol=4, fontsize=8, frameon=False, loc="upper left")
    fig.tight_layout()
    paths = [out_base + ext for ext in (".png", ".pdf")]
    for p in paths:
        fig.savefig(p, dpi=150)
    plt.close(fig)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("csv", help="tidy CSV from simulate")
    p.add_argument("--out", default="results",
                   help="output directory for cycles.* and energy.*")
    p.add_argument("--accels", nargs="*", default=None, choices=ACCELS)
    args = p.parse_args(argv)
    _pyplot()
    rows = read_rows(args.csv)
    os.makedirs(args.out, exist_ok=True)
    written = []
    written += plot_cycles(rows, os.path.join(args.out, "cycles"),
                           args.accels)
    written += plot_energy(rows, os.path.join(args.out, "energy"),
                           args.accels)
    for w in written:
        print(f"wrote {w}")


if __name__ == "__main__":
    main()
