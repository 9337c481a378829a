"""The readings that a cell's limit is set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 \\
        --seconds 30

For each seed, one run of the cell as the benchmark runs it (set-up,
the window, the check), then on the same sample of served requests the
control: the plain reference computed one step below the
configuration's precisions in the program's place (``check.py``). Prints
one JSON line per seed with the program's mean gap (``mean_gap``) and
the control's (``control_gap``), each sample's gaps summarised beside
them. The lower reading of a limit is the largest ``mean_gap`` of sound
runs over a dozen seeds or more, the upper the smallest
``control_gap``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seeds, seconds: float, device="cuda",
             cell=None, fault=None) -> list:
    """One run a seed, with the control read on its sample; ``fault``
    plants one of ``faults.FAULTS`` under the timed path."""
    import contextlib
    from portbench import faults, harness, spec
    cell = cell or spec.cell(workload, ROOT)
    out = []
    for seed in seeds:
        with faults.planted(fault) if fault else contextlib.nullcontext():
            rec, v = harness.run(cell, seed, seconds, False, device,
                                 control=True)
        out.append({"workload": cell.name, "seed": seed, "fault": fault,
                    "mean_gap": v["mean_gap"], "control_gap": v["control_gap"],
                    "stats": v["stats"], "control_stats": v["control_stats"],
                    "tokens": v["tokens"], "requests": v["requests"],
                    "buckets": v["buckets"], "check_s": v["seconds"],
                    "window_tokens": rec.window.tokens})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", choices=("token", "unchanged"))
    args = ap.parse_args(argv)
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             args.seconds, fault=args.fault)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
