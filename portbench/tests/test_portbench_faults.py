"""The check catches a broken timed path: a whole run of each cell at a
tiny preset on the CPU (the harness's look for a card skipped), with a
fault planted under ``step`` / ``step_chunk`` (``portbench/faults.py``),
comes out not correct; the same run without the fault comes out correct.

The engine computes in float32 here, where the port's plain route and
the plain reference do the same arithmetic: a sound run reads a gap of
0 up to rounding at a near-tie, far below ``LIMIT``, and every planted
fault reads above it (mean gaps 0.04 to 0.34 over seeds 1-3 when this
test was written).
"""

from __future__ import annotations

import pytest
import torch

import portbench_tiny as pt
from portbench import faults, harness, spec

CELLS = [w["name"] for w in spec.benchmark(pt.ROOT)["workloads"]]
LIMIT = 1e-3
SEEDS = (1, 2 ** 31 + 9)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(name: str):
    cell = pt.tiny_cell(name)
    cell.config["engine"]["dtype"] = "float32"
    cell.limits = {"mean_gap": {"limit": LIMIT}}
    return cell


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, seed):
    _, verdict = harness.run(_cell(name), seed, 1.0, False, "cpu")
    assert verdict["correct"] is True, verdict


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, seed):
    with faults.planted(fault):
        _, verdict = harness.run(_cell(name), seed, 1.0, False, "cpu")
    assert verdict["correct"] is False, verdict
