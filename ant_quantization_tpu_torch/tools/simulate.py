"""Accelerator cycle/energy simulation CLI (run_ant.py equivalent).

Counterpart of the reference's ``tools/simulate.py``, with its flags
plus ``--device``: sweeps the six accelerator configurations over the
benchmark nets at the given batch size, prints the normalized-cycles/
energy summary table, and writes the tidy per-(network, accelerator)
CSV. The tiling search runs on ``--device``: the card by default (it
raises without one), or ``--device cpu``.

    python -m ant_quantization_tpu_torch.tools.simulate --batch 64 \\
        --out results/ant_res.csv
    python -m ant_quantization_tpu_torch.tools.simulate \\
        --nets vgg16 resnet50 --device cpu
"""

from __future__ import annotations

import argparse

from ..perfmodel.nets import BENCHLIST
from ..perfmodel.results import format_summary, normalized_results, write_csv

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--nets", nargs="*", default=None, choices=BENCHLIST,
                   help="subset of networks (default: all 8)")
    p.add_argument("--out", default="results/ant_res.csv")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tiling search")
    args = p.parse_args(argv)

    rows = normalized_results(batch=args.batch, nets=args.nets,
                              device=args.device)
    print(format_summary(rows))
    write_csv(rows, args.out)
    print(f"\nwrote {len(rows)} rows to {args.out}")


if __name__ == "__main__":
    main()
