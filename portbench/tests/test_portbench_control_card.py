"""The check's two readings on the card, at each cell's full size and
its own limit: the control comes out not correct, and so does a decode
that writes no key or value into the cache.

- The control: one run as the benchmark runs it, then the plain
  reference computed one step below the configuration's precisions in
  the program's place, read on the same sample (``portbench/control.py``).
  The program's mean gap must be within the cell's limit and the
  control's beyond it.
- The fault: the same run with every decode tick returning the cache
  unchanged (``faults.py``, ``unchanged``); its mean gap must be beyond
  the cell's limit.

The readings that set the limits ran the same code at the cell's own
window on a dozen seeds a cell (PERF.md); here one seed and a 30 s
window keep each run to a few minutes. On the card, from the
repository's root:

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_control_card.py
"""

from __future__ import annotations

import pytest
import torch

import portbench_tiny as pt
from portbench import control, spec

CELLS = [w["name"] for w in spec.benchmark(pt.ROOT)["workloads"]]


def _limit(name: str) -> float:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check runs the cell at "
                    "full size")
    return spec.cell(name, pt.ROOT).limits["mean_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    limit = _limit(name)
    (r,) = control.readings(name, [2 ** 31 + 4242], 30.0, "cuda")
    assert r["mean_gap"] <= limit < r["control_gap"], r


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_decode_without_cache_writes_is_not_correct(name):
    limit = _limit(name)
    (r,) = control.readings(name, [2 ** 31 + 4343], 30.0, "cuda",
                            fault="unchanged")
    assert r["mean_gap"] > limit, r
