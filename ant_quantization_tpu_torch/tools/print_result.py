"""Aggregate result JSONs into the reference's README-style tables.

Counterpart of the reference's ``tools/print_result.py``. The reference
regenerates its accuracy tables by grepping run logs
(ant_quantization/ImageNet/scripts/print_result.sh); the port's command
lines write a structured ``--output`` JSON instead, and this aggregates a
directory of them into one table per workload family, with the mode
columns named as in the papers (Int / IP / FIP / IP-F / FIP-F; plus
ANT4-8 when n8/layers8 was set, inferred from the run file name's
*_ANT4-8 suffix or an "n8" field). Host Python only.

Usage:
  python -m ant_quantization_tpu_torch.tools.print_result results/
  python -m ant_quantization_tpu_torch.tools.print_result \
      results/*.json --metric top1
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

__all__ = ["MODE_COLUMNS", "PRIMARY_METRIC", "column_for", "metric_for",
           "row_key", "main"]

MODE_COLUMNS = [
    ("int", "Int"),
    ("ant-int-pot", "IP"),
    ("ant-int-pot-float", "FIP"),
    ("ant-int-pot-flint", "IP-F"),
    ("ant-int-pot-float-flint", "FIP-F"),
    ("ant-int-pot-flint-float", "FIP-F"),
    ("ant-int-flint", "OliVe"),
]

PRIMARY_METRIC = ["top1", "accuracy", "mcc", "f1", "exact_match",
                  "perplexity", "pearson"]


def column_for(row: dict, path: str) -> str:
    if row.get("n8") or "ANT4-8" in os.path.basename(path):
        return "ANT4-8"
    for mode, col in MODE_COLUMNS:
        if row.get("mode") == mode:
            return col
    return row.get("mode", "?")


def metric_for(row: dict, prefer: str = "") -> tuple:
    if prefer and prefer in row:
        return prefer, row[prefer]
    for m in PRIMARY_METRIC:
        if m in row:
            return m, row[m]
    return "", float("nan")


def row_key(row: dict) -> str:
    return row.get("model") or row.get("task") or row.get("dataset") or "?"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs="+",
                   help="result json files or directories")
    p.add_argument("--metric", default="",
                   help="metric key to tabulate (default: first of "
                        f"{PRIMARY_METRIC})")
    args = p.parse_args(argv)

    files = []
    for path in args.paths:
        if os.path.isdir(path):
            files += sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                      recursive=True))
        else:
            files.append(path)
    if not files:
        raise SystemExit("no result files")

    table = {}          # row key -> column -> (metric, value)
    columns = []
    for path in files:
        try:
            with open(path) as f:
                row = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"skip {path}: {e}", file=sys.stderr)
            continue
        if not isinstance(row, dict) or "mode" not in row:
            continue
        col = column_for(row, path)
        m, val = metric_for(row, args.metric)
        if not m:
            continue
        table.setdefault(row_key(row), {})[col] = (m, val)
        if col not in columns:
            columns.append(col)

    if not table:
        raise SystemExit("no tabulatable results (need json dicts with a "
                         "'mode' key)")

    order = [c for _, c in MODE_COLUMNS if c in columns]
    order += [c for c in columns if c not in order]
    if "ANT4-8" in order:
        order.remove("ANT4-8")
        order.append("ANT4-8")

    width = max(len(k) for k in table) + 2
    print(" " * width + " | ".join(f"{c:>8}" for c in order))
    for key in sorted(table):
        cells = []
        for c in order:
            m, v = table[key].get(c, ("", float("nan")))
            cells.append(f"{v:8.2f}" if v == v else " " * 8)
        print(f"{key:<{width}}" + " | ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
