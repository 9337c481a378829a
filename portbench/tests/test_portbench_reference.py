"""The plain references (``portbench/reference/``) against the port's
plain CPU route at a tiny preset of each configuration.

With the engine computing in float32, the port's plain versions of its
kernels and the reference compute the same arithmetic in other orders:
logits agree within 1e-5 (a few float32 ulps of values near 0.3; an A4
code moved by an ulp would show as a difference thousands of times
larger). The lower-precision control must differ by far more.
"""

from __future__ import annotations

import pytest
import torch

import portbench_tiny as pt
from portbench import harness, spec, weights

CONFIGS = (("opt-6.7b-ant-w4a4", "opt"), ("bloom-7b1-ant-w4a4", "bloom"))
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name: str, family: str):
    from ant_quantization_tpu_torch.serve import engine as eng
    cfg = pt.tiny_config(name)
    cfg["engine"]["dtype"] = "float32"
    ecfg = harness.engine_config(cfg)
    ep = weights.make(cfg, 5, "cpu")
    ref = spec.module(pt.PKG / "reference" / f"{family}.py")
    ids = torch.randint(0, cfg["lm"]["vocab_size"], (1, 40),
                        generator=torch.Generator().manual_seed(3))
    h = ref.final_hidden(cfg, ep, [ids[0].tolist()], "f32", "cpu")[0]
    return eng, cfg, ecfg, ep, ref, ids, ref.head_logits(ep, h, "f32")


@pytest.mark.parametrize("name,family", CONFIGS)
def test_prefill_logits_match_port(name, family):
    eng, cfg, ecfg, ep, ref, ids, want = _setup(name, family)
    got, _ = eng.forward(ecfg, ep, ids, eng.init_cache(ecfg, 1, "cpu"), 0)
    assert float((got[0] - want).abs().max()) < TOL


@pytest.mark.parametrize("name,family", CONFIGS)
def test_decode_through_int8_cache_matches_port(name, family):
    """A 20-token prefill, then one position at a time through the INT8
    cache, against the reference's whole-sequence forward."""
    eng, cfg, ecfg, ep, ref, ids, want = _setup(name, family)
    kv = eng.init_cache(ecfg, 1, "cpu")
    out, _ = eng.forward(ecfg, ep, ids[:, :20], kv, 0, last_index=19)
    rows = [out[0, -1]]
    for t in range(20, 39):
        out, _ = eng.forward(ecfg, ep, ids[:, t:t + 1], kv,
                             torch.tensor([t], dtype=torch.int32))
        rows.append(out[0, -1])
    assert float((torch.stack(rows) - want[19:39]).abs().max()) < TOL


@pytest.mark.parametrize("name,family", CONFIGS)
def test_lower_precision_control_differs(name, family):
    eng, cfg, ecfg, ep, ref, ids, want = _setup(name, family)
    lo = ref.head_logits(ep, ref.final_hidden(
        cfg, ep, [ids[0].tolist()], "lower", "cpu")[0], "lower")
    assert float((lo - want).abs().max()) > 100 * TOL


def test_reference_found_by_family():
    for name, family in CONFIGS:
        assert pt.tiny_config(name)["family"] == family
