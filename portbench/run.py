"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the set-up's parts and the check's numbers on standard error and,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``check`` (each number compared, beside its
limit). Exits non-zero, printing no result, without as many CUDA devices
as the cell asks for, and when JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ant_quantization_tpu")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness, report, spec

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec, verdict = harness.run(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", t_start=T0)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    line = report.line(rec, verdict, bool(args.trace))
    for msg in report.notes(rec, verdict):
        print(f"portbench: {msg}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    for msg in report.check_lines(verdict):
        print(msg, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
