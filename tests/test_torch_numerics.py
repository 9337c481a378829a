"""PyTorch port vs the JAX reference: codebooks, grid snap and the
int8-value weight packing. All comparisons are bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels import qmatmul as jq
from ant_quantization_tpu.numerics import codebooks as jcb
from ant_quantization_tpu.ops import snap as jsnap
from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.numerics import codebooks as tcb
from ant_quantization_tpu_torch.ops import snap as tsnap

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

_MODES = ("int", "pot", "apot", "float", "float1", "flint")


@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("signed", [True, False])
def test_ant_grid_matches_reference(mode, signed):
    np.testing.assert_array_equal(tcb.ant_grid(mode, 4, signed),
                                  jcb.ant_grid(mode, 4, signed))


def _snap_inputs(grid: np.ndarray, seed: int) -> np.ndarray:
    """Random values plus every grid entry and every midpoint (the tie
    cases), in float32."""
    g = grid.astype(np.float32)
    mids = (g[1:] + g[:-1]) * np.float32(0.5)
    rng = np.random.default_rng(seed)
    rnd = rng.uniform(g.min() - 2, g.max() + 2, 500).astype(np.float32)
    return np.concatenate([rnd, g, mids, -mids, np.float32([0.0, -0.0])])


@pytest.mark.parametrize("signed", [True, False])
def test_snap_codes_and_values_bit_equal(signed):
    grid = tcb.ant_grid("flint", 4, signed)
    if signed:   # the signed flint grid holds 0 twice; codes must agree
        assert int(np.sum(grid == 0)) == 2
    x = _snap_inputs(grid, seed=int(signed))
    want_c = np.asarray(jsnap.snap_codes(jnp.asarray(x), jnp.asarray(grid)))
    want_v = np.asarray(jsnap.snap_value(jnp.asarray(x), jnp.asarray(grid)))
    got_c = tsnap.snap_codes(torch.from_numpy(x),
                             torch.from_numpy(grid)).numpy()
    got_v = tsnap.snap_value(torch.from_numpy(x),
                             torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_v, want_v)


@pytest.mark.parametrize("mode", ["flint", "int", "pot", "float"])
def test_int8_codebook_bit_equal(mode):
    for signed in (True, False):
        g = tcb.ant_grid(mode, 4, signed)
        q_t, u_t, e_t = tq.int8_codebook(g)
        q_j, u_j, e_j = jq.int8_codebook(g)
        np.testing.assert_array_equal(q_t, q_j)
        assert (u_t, e_t) == (u_j, e_j)


@pytest.mark.parametrize("mode", ["flint", "int"])
def test_quantize_weights_w4_i8_bit_equal(mode):
    rng = np.random.default_rng(3)
    K, N = 48, 40
    w = rng.normal(size=(K, N)).astype(np.float32)
    grid = tcb.ant_grid(mode, 4, True)
    alpha = np.abs(rng.normal(size=(N,)) + 1.5).astype(np.float32)
    want_w, want_s = jq.quantize_weights_w4_i8(
        jnp.asarray(w), jnp.asarray(grid), jnp.asarray(alpha))
    got_w, got_s = tq.quantize_weights_w4_i8(torch.from_numpy(w), grid,
                                             alpha)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
