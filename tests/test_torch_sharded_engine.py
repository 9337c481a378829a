"""PyTorch port vs the JAX reference: the tensor-parallel engine
(``serve/sharded.py``, the engine's TP epilogue and its sequence-parallel
prefill) on gloo CPU ranks, against the reference's sharded forward under
``shard_map`` on the 8-device CPU mesh.

The cases are those of the reference's ``tests/test_sharded_engine.py``
at (dp, tp) = (1, 2), (2, 2) and (1, 4), with its tolerances (2e-4; 5e-3
for W4A4 and w4pack; 2e-2 for the decode step; 0.06 and the same argmax
for the int8 head), on float weights with hand-built quantizer states
(``_torch_ranks.engine_model``). One world of four ranks runs every case
once (the ``ranks`` fixture); each test holds one case.

Beyond the reference: the sequence-parallel prefill of int8-exact sites
equals the port's single-device prefill bit for bit (logits and each
rank's cache shard), and torch.profiler's collective events show no
all-reduce in it and two per layer in a decode step.
"""

import functools

import numpy as np
import pytest
import torch

import _torch_ranks as R
from ant_quantization_tpu_torch.parallel.distributed import run_ranks

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

TOL = {"w4a4-int8kv": 5e-3, "w4pack": 5e-3}
DECODE_TOL = 2e-2
INT8_HEAD_ATOL = 0.06


@pytest.fixture(scope="module")
def ranks():
    """Every case on one world of four gloo CPU ranks: one dict a rank."""
    res = run_ranks(R.engine_cases, R.WORLD, threads=1, timeout_s=300)
    return [res[r] for r in range(R.WORLD)]


def _jax_state(st):
    import jax.numpy as jnp
    from ant_quantization_tpu.calibrate.spec import QuantState
    return QuantState(**{k: jnp.asarray(v) for k, v in st.items()})


def _jax_tree(node):
    if isinstance(node, dict) and "alpha" in node:
        return _jax_state(node)
    if isinstance(node, dict):
        return {k: _jax_tree(v) for k, v in node.items()}
    return node


@functools.lru_cache(maxsize=None)
def _jax(case: str) -> dict:
    """The reference's sharded forward of one case (and what it runs)."""
    import jax
    import jax.numpy as jnp
    from ant_quantization_tpu.models.transformer_lm import LMConfig
    from ant_quantization_tpu.parallel.mesh import make_mesh
    from ant_quantization_tpu.serve import engine as eng
    from ant_quantization_tpu.serve import sharded as sh
    geom_kw, kind, eng_kw, (dp, tp), _, what = R.ENGINE_CASES[case]
    geom = R._geom(**geom_kw)
    cfg = eng.EngineConfig(lm=LMConfig(**geom), dtype=jnp.float32,
                           interpret=True, **{**R.ENGINE_DEFAULTS, **eng_kw})
    params, quant = R.engine_model(geom, kind)
    ep = eng.build_engine_params(cfg, params, _jax_tree(quant)
                                 if quant else None)
    mesh = make_mesh((dp, tp), devices=jax.devices("cpu")[:dp * tp])
    tcfg = sh.tp_engine_config(cfg, mesh)
    eps = sh.shard_engine_params(ep, tcfg, mesh)
    fwd = sh.make_sharded_forward(tcfg, mesh)
    ids = jnp.asarray(R.engine_inputs(case))
    B = ids.shape[0]
    kv = sh.shard_cache(eng.init_cache(cfg, B if what != "batcher" else 2),
                        mesh)
    out = {}
    if what == "batcher":
        from ant_quantization_tpu.serve.scheduler import (ContinuousBatcher,
                                                          Request)
        cb = ContinuousBatcher(tcfg, eps, batch_slots=2,
                               prefill_buckets=(8,), forward_fn=fwd, kv=kv)
        for prompt, n in R.BATCHER_REQUESTS:
            cb.submit(Request(prompt=prompt, max_new_tokens=n))
        out["completions"] = {c.id: list(map(int, c.tokens))
                              for c in cb.run()}
        return out
    li = (jnp.asarray(R.SP_LAST_INDEX, jnp.int32) if what == "sp_last"
          else None)
    logits, kv = fwd(eps, ids, kv, jnp.zeros((B,), jnp.int32), li)
    out["logits"] = np.asarray(logits)
    if what == "decode":
        tok = jnp.argmax(logits[:, -1:], axis=-1)
        l2, _ = fwd(eps, tok, kv, jnp.full((B,), ids.shape[1], jnp.int32))
        out["decode_logits"] = np.asarray(l2)
    return out


def _mesh_ranks(res, case):
    """The results of the ranks of the case's (dp, tp) mesh, and the
    (dp-ordered) ranks at tp index 0."""
    dp, tp = R.ENGINE_CASES[case][3]
    mine = [r[case] for r in res[:dp * tp]]
    firsts = sorted((r for r in mine if r["tp_index"] == 0),
                    key=lambda r: r["dp_index"])
    return mine, firsts


def _gathered(res, case, key):
    """A per-rank (B_loc, ...) result over the dp ranks, after checking
    that every tp rank of a dp block holds the same values."""
    mine, firsts = _mesh_ranks(res, case)
    for r in mine:
        np.testing.assert_array_equal(r[key], firsts[r["dp_index"]][key])
    return np.concatenate([r[key] for r in firsts])


@pytest.mark.parametrize("case", [c for c, v in R.ENGINE_CASES.items()
                                  if v[5] != "batcher"])
def test_sharded_forward_matches_reference(case, ranks):
    """Port's sharded prefill (and decode step) against the reference's,
    at the reference test's tolerance."""
    got = _gathered(ranks, case, "logits")
    want = _jax(case)["logits"]
    assert got.shape == want.shape
    if case == "int8-head":
        # an ulp of TP sum order can move an int8 code of the head's
        # per-token scale: within about one code step, same tokens
        np.testing.assert_allclose(got, want, atol=INT8_HEAD_ATOL, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        tol = TOL.get(case, 2e-4)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if case == "w4a4-int8kv":
        assert all(r[case]["cache_written"] > 0 for r in ranks)
    if R.ENGINE_CASES[case][5] == "decode":
        np.testing.assert_allclose(
            _gathered(ranks, case, "decode_logits"),
            _jax(case)["decode_logits"], rtol=DECODE_TOL, atol=DECODE_TOL)


def test_continuous_batching_over_tp_mesh(ranks):
    """The port's ContinuousBatcher over the sharded forward serves both
    requests with the reference batcher's greedy tokens, on every rank."""
    want = _jax("continuous-batching")["completions"]
    mine, _ = _mesh_ranks(ranks, "continuous-batching")
    for r in mine:
        got = {int(k): list(map(int, v))
               for k, v in r["completions"].items()}
        assert sorted(len(v) for v in got.values()) == [3, 4]
        assert got == want


SP_CASES = [c for c, v in R.ENGINE_CASES.items() if v[5].startswith("sp")]


@pytest.mark.parametrize("case", SP_CASES)
def test_sp_prefill_against_the_single_device_prefill(case, ranks):
    """The rings own the prefill (the gate passes on every rank). Plain
    int8 sites: logits and every rank's cache shard equal the port's
    single-device prefill bit for bit (int32 ring sums are exact). OliVe
    sites: the row rings sum f32 quad-dot partials per K shard and the
    single-device prefill fake-quantizes, so within the reference's
    2e-4."""
    mine, firsts = _mesh_ranks(ranks, case)
    assert all(r["sp_gate"] for r in mine)
    for r in mine:
        if R.ENGINE_CASES[case][1] == "ant":
            np.testing.assert_array_equal(r["logits"], r["single_logits"])
            for got, want in zip(r["cache_local"], r["single_cache_local"]):
                np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(r["logits"], r["single_logits"],
                                       rtol=2e-4, atol=2e-4)


def test_sp_prefill_makes_no_all_reduce(ranks):
    """The sequence-parallel prefill's collectives, by torch.profiler:
    ring exchanges and no all-reduce (the reference's HLO check)."""
    for case in SP_CASES:
        for r in _mesh_ranks(ranks, case)[0]:
            ops = r["prefill_collectives"]
            assert "c10d::allreduce_" not in ops, (case, ops)
            assert ops.get("c10d::send", 0) > 0, (case, ops)
            assert ops.get("c10d::recv_", 0) > 0, (case, ops)


def test_decode_two_all_reduces_per_layer(ranks):
    """A TP decode step makes exactly two all-reduces per layer (attn out
    and fc_out) and no other collective."""
    for r in _mesh_ranks(ranks, "sp-ant-fused")[0]:
        ops = r["decode_collectives"]
        assert ops == {"c10d::allreduce_": 2 * 2}, ops
