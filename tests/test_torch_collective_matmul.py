"""PyTorch port vs the JAX reference: the ring collective matmuls
(``parallel/collective_matmul.py``) and the GPipe schedule
(``parallel/pipeline.py``) on gloo CPU ranks, against the reference's
functions under ``shard_map`` on the 8-device CPU mesh.

One world of four ranks runs every case once (the ``ranks`` fixture);
each test holds one case. The int8 rings with plain operands are
bit-equal to the reference's in int32. The OVP forms combine exact int32
dots in f32 (16 a - 15 b, or the four-term form): XLA:CPU may contract
that combine into fused multiply-adds (ROADMAP, "Deliberate
differences"), the port rounds each product, so they agree within
``OVP_RTOL`` of the largest combined value. The f32 rings and the
pipeline hold the reference tests' tolerances (f32 products summed in
other orders).
"""

import functools

import numpy as np
import pytest

import _torch_ranks as R
from ant_quantization_tpu_torch.parallel.distributed import run_ranks

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

# an FMA keeps 16 a exact where the port rounds 16 a - 15 b once more:
# a few f32 ulps of the largest term
OVP_RTOL = 1e-6


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(R.collective_cases, R.WORLD, threads=1, timeout_s=300)


def _mesh(p, axis="tp"):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices("cpu")[:p]), (axis,))


@functools.lru_cache(maxsize=None)
def _jax_ring(kind: str, p: int, w_ovp: bool = False,
              a_ovp: bool = False) -> np.ndarray:
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from ant_quantization_tpu.parallel import collective_matmul as cm
    x, w = R.ring_inputs(kind, p, w_ovp, a_ovp)
    fn = {"ag": cm.ring_allgather_matmul, "rs": cm.matmul_reducescatter,
          "ag_i8": cm.ring_allgather_matmul_i8,
          "rs_i8": cm.matmul_reducescatter_i8}[kind]
    kw = dict(w_ovp=w_ovp, a_ovp=a_ovp) if kind.endswith("i8") else {}
    if kind.startswith("ag"):
        specs = (P("tp", None), P(None, "tp")), P(None, "tp")
    else:
        specs = (P(None, "tp"), P("tp", None)), P("tp", None)
    got = shard_map(lambda a, b: fn(a, b, "tp", **kw), mesh=_mesh(p),
                    in_specs=specs[0], out_specs=specs[1],
                    check_vma=False)(x, w)
    return np.asarray(got)


def _port_ring(ranks, kind: str, p: int, key: str) -> np.ndarray:
    """The case's output over the p ranks of a tp group: the all-gather
    rings' column blocks side by side, the reduce-scatter rings' row
    blocks stacked."""
    parts = [ranks[r][key] for r in range(p)]
    return np.concatenate(parts, axis=1 if kind.startswith("ag") else 0)


@pytest.mark.parametrize("p", R.RING_PS)
@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_f32_ring_matches_reference(kind, p, ranks):
    got = _port_ring(ranks, kind, p, f"{kind}-f32-p{p}")
    want = _jax_ring(kind, p)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # and the unfused product, as the reference's tests hold it
    x, w = R.ring_inputs(kind, p)
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", R.RING_PS)
@pytest.mark.parametrize("kind", ["ag_i8", "rs_i8"])
def test_int8_ring_bit_equal_to_reference(kind, p, ranks):
    got = _port_ring(ranks, kind, p, f"{kind[:2]}-i8-w0a0-p{p}")
    want = _jax_ring(kind, p)
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    x, w = R.ring_inputs(kind, p)
    np.testing.assert_array_equal(got, x.astype(np.int64)
                                  @ w.astype(np.int64))


@pytest.mark.parametrize("p", R.RING_PS)
@pytest.mark.parametrize("form", R.OVP_FORMS,
                         ids=lambda f: f"w_ovp{int(f[0])}-a_ovp{int(f[1])}")
@pytest.mark.parametrize("kind", ["ag_i8", "rs_i8"])
def test_ovp_ring_matches_reference(kind, form, p, ranks):
    w_ovp, a_ovp = form
    got = _port_ring(ranks, kind, p,
                     f"{kind[:2]}-i8-w{int(w_ovp)}a{int(a_ovp)}-p{p}")
    want = _jax_ring(kind, p, w_ovp, a_ovp)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OVP_RTOL * np.abs(want).max())


def test_roundtrip_column_then_row(ranks):
    """A full TP layer: the all-gather ring in, tanh, the reduce-scatter
    ring out, against the dense computation."""
    x, w1, w2 = R.roundtrip_inputs()
    got = np.concatenate([ranks[r]["roundtrip-p4"] for r in range(4)])
    np.testing.assert_allclose(got, np.tanh(x @ w1) @ w2, rtol=1e-4,
                               atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_gpipe(pp: int, M: int) -> np.ndarray:
    import jax.numpy as jnp
    from ant_quantization_tpu.parallel.pipeline import (gpipe,
                                                        shard_stage_params)
    stack, x = R.gpipe_inputs(pp, M)

    def seq(params, h):
        for i in range(params["w"].shape[0]):
            h = jnp.tanh(h @ params["w"][i] + params["b"][i])
        return h

    mesh = _mesh(pp, "pp")
    return np.asarray(gpipe(seq, mesh)(shard_stage_params(
        {k: jnp.asarray(v) for k, v in stack.items()}, mesh),
        jnp.asarray(x)))


@pytest.mark.parametrize("pp,M", R.GPIPE_CASES)
def test_gpipe_matches_reference(pp, M, ranks):
    """Every stage ends with the last stage's outputs; they match the
    reference's pipeline and the sequential stack."""
    key = f"gpipe-pp{pp}-M{M}"
    got = ranks[0][key]
    for r in range(R.WORLD):
        np.testing.assert_array_equal(ranks[r][key], got)
    np.testing.assert_allclose(got, _jax_gpipe(pp, M), rtol=1e-5,
                               atol=1e-5)
    stack, x = R.gpipe_inputs(pp, M)
    want = x
    for w, b in zip(stack["w"], stack["b"]):
        want = np.tanh(want @ w + b)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
