"""PyTorch port vs the JAX reference: ``utils/profiling.py``.
``StepTimer.summary`` on the same step times (several warm-up skips, the
empty and the short lists), ``maybe_trace`` without a directory and
``profile_dir_from_env`` under the same environment, equal to the
reference's; ``trace`` with ``annotate`` on the CPU writes a TensorBoard
trace that names the region; ``fence`` takes a nested tree and picks the
reference's first leaf."""

import glob
import json
import os

import pytest
import torch

import jax

from ant_quantization_tpu.utils import profiling as jprof
from ant_quantization_tpu_torch.utils import profiling as tprof

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

TIMES = {"seven": [0.5, 0.013, 0.011, 0.017, 0.012, 0.0105, 0.02],
         "empty": [], "one": [0.25], "two": [0.3, 0.1]}


@pytest.mark.parametrize("skip", [0, 1, 2, 6, 7, 10])
@pytest.mark.parametrize("name", sorted(TIMES))
def test_step_timer_summary_matches_reference(name, skip):
    j, t = jprof.StepTimer(), tprof.StepTimer()
    j.times, t.times = list(TIMES[name]), list(TIMES[name])
    assert t.summary(skip) == j.summary(skip)
    assert t.summary() == j.summary()


def test_step_timer_steps_and_fence():
    """step() appends one time per step; fence() adds the wait to the
    previous step and is a no-op before the first."""
    t = tprof.StepTimer()
    t.fence(torch.ones(2))
    assert t.times == []
    for _ in range(3):
        with t.step():
            y = torch.ones(8) * 2
        before = t.times[-1]
        t.fence({"y": y})
        assert t.times[-1] >= before
    assert len(t.times) == 3 and t.summary()["steps"] == 2


@pytest.mark.parametrize("value", [None, "", "/some/dir"])
def test_profile_dir_from_env_matches_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("ANT_TPU_PROFILE", raising=False)
    else:
        monkeypatch.setenv("ANT_TPU_PROFILE", value)
    assert tprof.profile_dir_from_env() == jprof.profile_dir_from_env()


@pytest.mark.parametrize("logdir", [None, ""])
def test_maybe_trace_without_a_directory_matches_reference(logdir):
    with jprof.maybe_trace(logdir) as jd, tprof.maybe_trace(logdir) as td:
        assert td == jd is None


def _events(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_trace_naming_the_region(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as d:
        assert d == logdir
        with tprof.annotate("square_sum"):
            x = torch.arange(128.0)
            y = (x * x).sum()
            tprof.fence(y)
    assert float(y) == float(sum(i * i for i in range(128)))
    names = {e.get("name") for e in _events(logdir)}
    assert "square_sum" in names
    assert any(n and "mul" in n for n in names), names


def test_maybe_trace_with_a_directory_traces(tmp_path, monkeypatch):
    monkeypatch.setenv("ANT_TPU_PROFILE", str(tmp_path / "env"))
    with tprof.maybe_trace(tprof.profile_dir_from_env()) as d:
        with tprof.annotate("step"):
            torch.ones(4).add_(1)
    assert d == str(tmp_path / "env")
    assert "step" in {e.get("name") for e in _events(d)}


def test_fence_takes_a_nested_tree_and_the_reference_first_leaf():
    a, b = torch.zeros(3), torch.ones(2)
    tree = {"b": [b], "a": (7, {"z": a})}
    tprof.fence(tree)
    for empty in (None, [], {}, (), {"a": [1, 2.0]}):
        tprof.fence(empty)
    # the reference fences jax.tree_util's first leaf: dicts in sorted
    # key order (a non-tensor leaf is skipped here: nothing to wait for)
    assert jax.tree_util.tree_leaves({"b": 1, "a": 2})[0] == 2
    assert tprof._first_tensor(tree) is a
    assert tprof._first_tensor([(None, b), a]) is b
    assert tprof._first_tensor({"a": [1, 2.0]}) is None
