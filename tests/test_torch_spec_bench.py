"""PyTorch port vs the JAX reference: ``tools/spec_bench.py``.
At a tiny OPT-shaped ``_lm`` the port's JSON line has the reference's
keys, nested ones included, and its non-timing values; ``spec_model`` is
the reference's modeled curve and break-even, whose expressions are taken
from the reference's source and run on hand-picked times; with the draft
params set to the target's every round accepts all k drafts, at 1 and at
8 rounds per call."""

import contextlib
import functools
import io
import json
import math
import os
import textwrap
import types
from unittest import mock

import numpy as np
import pytest
import torch

from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.tools import spec_bench

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)
from test_torch_lm_bench import REPO, load_reference_tool

pytestmark = pytest.mark.torchdep

TINY = dict(vocab_size=128, d_model=128, n_heads=1, d_ff=256,
            positions="learned_offset2", activation="relu", fused_qkv=False)
PREFILL = 16
ARGV = ["--layers", "2", "--draft-layers", "1", "--batch", "2",
        "--prefill", str(PREFILL), "--rounds", "8"]
TIMING = {"t_plain_ms", "t_verify_ms", "t_draft_ms", "plain_tok_s",
          "break_even_accept", "tok_s_dispatch_per_round",
          "tok_s_8_rounds_per_dispatch", "accept_rate"}


def _tiny_lm(n_layers, max_seq):
    return LMConfig(**TINY, n_layers=n_layers, max_seq=max_seq)


def _json(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    line, = out.getvalue().splitlines()
    return json.loads(line)


@functools.lru_cache(maxsize=None)
def _ref_json() -> dict:
    """The reference's main on bench.py's ``_lm`` cut to TINY (its
    environment defaults restored afterwards)."""
    import bench
    max_seq = PREFILL + 64 + 32
    with mock.patch.dict(os.environ), \
            mock.patch.object(bench, "MAX_SEQ", max_seq), \
            mock.patch.object(bench, "_lm", lambda n: JLMConfig(
                **TINY, n_layers=n, max_seq=max_seq)):
        return _json(load_reference_tool("spec_bench").main, ARGV)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_json_line_matches_reference(monkeypatch):
    monkeypatch.setattr(spec_bench, "_lm", _tiny_lm)
    got = _json(spec_bench.main, ARGV + ["--device", "cpu"])
    want = _ref_json()
    assert _keys(got) == _keys(want)
    for k in ("k", "layers", "draft_layers"):
        assert got[k] == want[k]
    e2e = got["e2e_random_draft"]
    for name, v in [*got.items(), *e2e.items(),
                    *got["modeled_spec_tok_s"].items()]:
        if name in TIMING or name.startswith("a="):
            assert math.isfinite(v) and v >= 0, (name, v)
    assert isinstance(e2e["note"], str) and "host" in e2e["note"]
    # the curve and break-even are spec_model on the printed times
    # (within their rounding)
    t = {n: got[f"t_{n}_ms"] * 1e-3 for n in ("plain", "verify", "draft")}
    model, be = spec_bench.spec_model(t["plain"], t["verify"], t["draft"],
                                      4, 2)
    for a, v in got["modeled_spec_tok_s"].items():
        assert abs(v - model[a]) <= 0.05 + 0.01 * model[a]
    assert abs(got["break_even_accept"] - be) < 0.05


def _reference_model(t_plain, t_verify, t_draft, k, B):
    """tools/spec_bench.py's own model lines, run as they stand there."""
    with open(os.path.join(REPO, "tools", "spec_bench.py")) as f:
        src = f.read()
    start = src.index("    k = args.k\n")
    stop = src.index("\n", src.index("    break_even = ", start))
    ns = {"args": types.SimpleNamespace(k=k), "t_plain": t_plain,
          "t_verify": t_verify, "t_draft": t_draft, "B": B}
    exec(textwrap.dedent(src[start:stop]), ns)
    return ns["model"], ns["break_even"]


@pytest.mark.parametrize("times,k,B", [
    ((0.0123, 0.0141, 0.0042), 4, 4),
    ((0.050, 0.052, 0.011), 4, 4),
    ((0.0123, 0.0130, 0.0001), 4, 4),     # break-even clipped at 0
    ((0.00731, 0.00977, 0.00213), 3, 1),
    ((0.1, 0.3, 0.05), 7, 8)])
def test_spec_model_matches_reference_expressions(times, k, B):
    model, be = spec_bench.spec_model(*times, k, B)
    want_model, want_be = _reference_model(*times, k, B)
    assert {a: round(v, 1) for a, v in model.items()} == want_model
    assert round(be, 3) == round(want_be, 3)
    assert be == max(0.0, ((k * times[2] + times[1]) / times[0] - 1) / k)


def test_draft_equal_to_target_accepts_every_draft(monkeypatch):
    """The draft's params set to the target's (both seeds draw seed 0, at
    one depth): every round accepts all k drafts, at 1 and at 8 rounds
    per call, and accept_rate (the reference's batch sum over k) is 1.0
    at batch 1."""
    made = []

    class Recorder(spec_bench.SpeculativeDecoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    build = spec_bench.rand_engine_params
    monkeypatch.setattr(spec_bench, "_lm", _tiny_lm)
    monkeypatch.setattr(spec_bench, "SpeculativeDecoder", Recorder)
    monkeypatch.setattr(spec_bench, "rand_engine_params",
                        lambda cfg, seed, dev: build(cfg, 0, dev))
    got = _json(spec_bench.main, [
        "--layers", "2", "--draft-layers", "2", "--batch", "1",
        "--prefill", str(PREFILL), "--rounds", "16", "--device", "cpu"])
    assert got["e2e_random_draft"]["accept_rate"] == 1.0
    assert len(made) == 2
    for sd in made:
        assert sd.accepted_hist and all(
            n == sd.k for n in sd.accepted_hist), sd.accepted_hist
    assert float(np.mean(made[1].accepted_hist)) / 4 == 1.0


def test_main_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec_bench.main(["--layers", "1"])
