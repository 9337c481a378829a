"""PyTorch port vs the JAX reference: K1, the stacked snap + int8 matmul
(plain version, the CPU path of kernels/stacked.py), against the Pallas
kernel in interpret mode. Bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.stacked import stacked_quant_matmul as jk1
from ant_quantization_tpu_torch.kernels import stacked as tk1
from ant_quantization_tpu_torch.kernels.qmatmul import int8_codebook
from ant_quantization_tpu_torch.numerics import codebooks as cb

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep


@pytest.mark.parametrize("M", [3, 8])
def test_stacked_plain_bit_equal_to_pallas(M):
    L, K, N, l = 2, 256, 128, 1
    rng = np.random.default_rng(M)
    aq16, a_unit, _ = int8_codebook(cb.ant_grid("flint", 4, False))
    a_q = np.stack([aq16, aq16]).astype(np.float32)
    a_scale = np.float32([0.5, 0.25])     # powers of two keep the ties exact
    w = rng.integers(-64, 65, (L, K, N)).astype(np.int8)
    scales = rng.uniform(1e-3, 3e-3, (L, N)).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32) * 2
    # exact midpoint ties after the division by a_scale[l]
    mids = (a_q[l, 1:] + a_q[l, :-1]) * np.float32(0.5)
    x[0, :mids.shape[0]] = mids * a_scale[l]
    want = np.asarray(jk1(
        jnp.int32(l), jnp.asarray(x), jnp.asarray(w.reshape(L * K, N)),
        jnp.asarray(scales), jnp.asarray(a_q), jnp.asarray(a_scale[:, None]),
        None, mode="i8", n_layers=L, interpret=True))
    before = dict(tk1.COUNTS)
    got = tk1.stacked_quant_matmul(
        l, torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))),
        torch.from_numpy(scales), torch.from_numpy(a_q),
        torch.from_numpy(a_scale)).numpy()
    np.testing.assert_array_equal(got, want)
    # a CPU tensor takes the plain version, never the kernel
    assert tk1.COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert tk1.COUNTS["launches"] == before["launches"]


def test_int8_matmul_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (5, 40)).astype(np.int8)
    w = rng.integers(-127, 128, (24, 40)).astype(np.int8)
    got = tk1.int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)
