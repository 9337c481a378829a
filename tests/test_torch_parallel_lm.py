"""PyTorch port vs the JAX reference: the sharding rules
(``parallel/mesh.py``), the tensor-parallel ``TransformerLM`` forward over
local shards (``TransformerLM(..., tp_group=)`` through
``models/transformer_lm.py:tp_logits``) against the reference's GSPMD forward
on the 8-device CPU mesh, the multi-process runtime
(``parallel/distributed.py``) and ``tools/multihost_dryrun.py``.

One world of two "hosts" of two gloo CPU ranks runs the rank-side cases
once (the ``ranks`` fixture). The models are the reference test's
geometry (d_model 64, 4 heads, 2 layers) on float weights with
hand-built OliVe, ANT or no quantizer states; the sharded forward holds
the reference's 2e-4.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_ranks as R
from ant_quantization_tpu_torch.parallel import distributed as rt
from ant_quantization_tpu_torch.parallel import mesh as tmesh

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks():
    return rt.run_ranks(R.lm_cases, R.WORLD, local_world_size=2, threads=1,
                        timeout_s=300)


def test_spec_rules_match_reference():
    from ant_quantization_tpu.parallel import mesh as jmesh
    for mine, ref in ((tmesh.LM_PARAM_RULES, jmesh.LM_PARAM_RULES),
                      (tmesh.LM_QUANT_RULES, jmesh.LM_QUANT_RULES)):
        assert [(p, tuple(s)) for p, s in mine] == [(p, tuple(s))
                                                    for p, s in ref]
    rules = tmesh.LM_QUANT_RULES + tmesh.LM_PARAM_RULES
    for path in ("h_0/attn/qkv/kernel", "h_3/attn/out/kernel",
                 "h_1/fc_out/kernel", "h_1/ln_1/scale", "wte/embedding",
                 "h_0/fc_in/weight_q/alpha", "h_0/attn/q/bias",
                 "lm_head/kernel", "h_2/attn/v/weight_q/grid"):
        for r_mine, r_ref in ((tmesh.LM_PARAM_RULES, jmesh.LM_PARAM_RULES),
                              (rules, jmesh.LM_QUANT_RULES
                               + jmesh.LM_PARAM_RULES)):
            assert tuple(tmesh.spec_for_path(path, r_mine)) == tuple(
                jmesh.spec_for_path(path, r_ref)), path
    assert tmesh.spec_for_path("h_0/attn/qkv/kernel",
                               tmesh.LM_PARAM_RULES) == (None, "tp")
    assert tuple(tmesh.lm_batch_spec()) == tuple(jmesh.lm_batch_spec())
    assert tmesh._clip_spec(tmesh.P("tp", None), 1) == ("tp",)
    assert tmesh._clip_spec(tmesh.P("tp"), 0) == ()


def _jax_states(tree):
    import jax.numpy as jnp
    from ant_quantization_tpu.calibrate.spec import QuantState
    if isinstance(tree, dict) and "alpha" in tree:
        return QuantState(**{k: jnp.asarray(v) for k, v in tree.items()})
    return {k: _jax_states(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _gspmd(case: str) -> np.ndarray:
    """The reference's TransformerLM forward with params and states placed
    by its rules on a (dp, tp) mesh of the CPU devices (GSPMD)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from ant_quantization_tpu.models.transformer_lm import (LMConfig,
                                                            TransformerLM)
    from ant_quantization_tpu.nn.config import QuantConfig
    from ant_quantization_tpu.parallel.mesh import (LM_PARAM_RULES,
                                                    LM_QUANT_RULES,
                                                    lm_batch_spec, make_mesh,
                                                    shard_pytree)
    _, kind, (dp, tp) = R.LM_CASES[case]
    qcfg = {"olive": QuantConfig(mode="ant-int-flint", family="olive",
                                 w_low=100, w_up=101, a_low=100, a_up=101),
            "ant": QuantConfig(mode="flint", family="ant", w_low=100,
                               w_up=101, a_low=100, a_up=101),
            "float": QuantConfig(enabled=False)}[kind]
    model = TransformerLM(LMConfig(**R.lm_geom(case)), qcfg)
    params, quant = R.lm_model(case)
    mesh = make_mesh((dp, tp), devices=jax.devices("cpu")[:dp * tp])
    variables = {"params": shard_pytree(
        jax.tree_util.tree_map(jnp.asarray, params), mesh, LM_PARAM_RULES)}
    if quant:
        variables["quant"] = shard_pytree(_jax_states(quant), mesh,
                                          LM_QUANT_RULES + LM_PARAM_RULES)
    ids = jax.device_put(jnp.asarray(R.lm_inputs()),
                         NamedSharding(mesh, lm_batch_spec()))
    with mesh:
        return np.asarray(jax.jit(model.apply)(variables, ids))


@pytest.mark.parametrize("case", list(R.LM_CASES))
def test_sharded_lm_forward_matches_gspmd(case, ranks):
    """Each rank's logits are its batch rows' (the same on every rank of
    its tp group), within 2e-4 of the reference's GSPMD forward."""
    mine = [r[case] for r in ranks]         # every case's mesh is 4 ranks
    firsts = sorted((r for r in mine if r["tp_index"] == 0),
                    key=lambda r: r["dp_index"])
    for r in mine:
        np.testing.assert_array_equal(r["logits"],
                                      firsts[r["dp_index"]]["logits"])
    got = np.concatenate([r["logits"] for r in firsts])
    want = _gspmd(case)
    assert got.shape == want.shape == R.LM_BATCH + (R.LM_GEOM["vocab_size"],)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_hosts_and_their_data_shards(ranks):
    """Hosts are LOCAL_WORLD_SIZE consecutive ranks: the hybrid mesh puts
    dp across them and tp within one; a host's ranks read the same data
    shard and keep its rows."""
    ids = R.lm_inputs()
    for rank, r in enumerate(ranks):
        host = rank // 2
        assert tuple(r["process_shard"]) == (host, 2)
        assert tuple(r["hybrid_shape"]) == (2, 2)
        np.testing.assert_array_equal(r["host_rows"],
                                      ids[host * 2:(host + 1) * 2])


def test_nccl_refuses_two_ranks_on_one_card():
    """Two NCCL ranks on one card are refused up front, at the
    rendezvous, before NCCL or the card is touched (so on the CPU too)."""
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        rt.run_ranks(R.unreachable, 2, backend="nccl", device="cuda:0",
                     timeout_s=120)


def test_initialize_from_env(monkeypatch):
    """No variables: a no-op. ANT_DISTRIBUTED=1 without a launcher's
    variables names what is missing. ANT_COORDINATOR with one process:
    a world of one gloo rank on the CPU, joined once."""
    for k in ("ANT_COORDINATOR", "ANT_DISTRIBUTED", "RANK", "WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert rt.initialize_from_env(device="cpu") is False
    monkeypatch.setenv("ANT_DISTRIBUTED", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE, MASTER_ADDR"):
        rt.initialize_from_env(device="cpu")
    monkeypatch.delenv("ANT_DISTRIBUTED")
    monkeypatch.setenv("ANT_COORDINATOR", f"127.0.0.1:{rt.free_port()}")
    monkeypatch.setenv("ANT_NUM_PROCESSES", "1")
    monkeypatch.setenv("ANT_PROCESS_ID", "0")
    try:
        assert rt.initialize_from_env(device="cpu") is True
        assert rt.initialize_from_env(device="cpu") is False
        assert not rt.is_multiprocess()
        assert rt.process_shard() == (0, 1)
        assert str(rt.rank_device()) == "cpu"
        mesh = tmesh.make_mesh()
        assert tuple(mesh.shape) == (1, 1)
        rt.sync_global_devices()
    finally:
        rt.shutdown()
    with pytest.raises(ValueError, match="backend must be one of"):
        rt.initialize("127.0.0.1:1", 1, 0, "mpi", "cpu")
    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        rt.initialize("127.0.0.1:1", 1, 0, "nccl", "cpu")


def test_multihost_dryrun_two_hosts_of_two():
    """The port's dryrun at 2 processes x 2 devices: four CPU ranks, the
    TP train step against one process, the loss equal on every rank, and
    the TP serving step against the one-process engine."""
    p = subprocess.run(
        [sys.executable, "-m",
         "ant_quantization_tpu_torch.tools.multihost_dryrun",
         "--num-processes", "2", "--devices-per-process", "2",
         "--timeout", "240"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    out = p.stdout + p.stderr
    assert "MULTIHOST DRYRUN PASSED" in out, out[-3000:]
    assert out.count("MULTIHOST OK") == 4, out[-3000:]
    assert out.count("SERVING OK") == 4, out[-3000:]
    assert p.returncode == 0


def test_tp_bench_flags_and_line(monkeypatch, capsys):
    """The port's tp_bench takes the reference's flags with its defaults
    (plus ``--device`` and ``--backend``), starts its own dp x tp ranks
    and prints the reference's JSON keys from rank 0."""
    import importlib.util
    import json
    from ant_quantization_tpu_torch.tools import tp_bench
    spec = importlib.util.spec_from_file_location(
        "reference_tp_bench", os.path.join(REPO, "tools", "tp_bench.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want, got = vars(ref.parse_args([])), vars(tp_bench.parse_args([]))
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"device", "backend"}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k in ("ANT_COORDINATOR", "ANT_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert tp_bench.main(["--dp", "1", "--tp", "2", "--device", "cpu",
                          "--layers", "2", "--d_model", "128", "--n_heads",
                          "4", "--vocab", "256", "--batch", "2",
                          "--prefill", "64", "--decode", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mesh"] == {"dp": 1, "tp": 2} and line["devices"] == 2
    assert line["weight_mode"] == "w4" and line["sp_prefill"] is True
    assert line["backend"] == "gloo" and line["rank"] == 0
    for k in ("prefill_ms", "decode_tokens_per_s", "ms_per_step"):
        assert line[k] > 0, k
