"""PyTorch port vs the JAX reference: K9, the fused W8A8 matmul for a
standalone weight (plain version, the CPU path of
kernels/qmatmul.py:fused_w8a8_matmul), against the Pallas kernel in
interpret mode. Bit-equal, including on inputs that sit exactly on a
codebook midpoint after the multiply by 1 / a_scale (and off it after a
division, which K1 takes instead)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.qmatmul import fused_w8a8_matmul as jk9
from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.kernels.qmatmul import int8_codebook
from ant_quantization_tpu_torch.numerics import codebooks as cb

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

_K, _N = 256, 128
_A_SCALE = np.float32(0.19)         # not a power of two: x * inv != x / a


def _ties(a_q: np.ndarray) -> tuple[np.ndarray, int, int]:
    """One f32 input per midpoint m with f32(x * f32(1 / a_scale)) == m
    where such an x exists (the multiply skips some f32 values), preferring
    one whose division x / a_scale misses m; how many exist, and how many
    of those the division would snap differently."""
    inv = np.float32(1) / _A_SCALE
    xs, split, found = [], 0, 0
    for m in (a_q[1:] + a_q[:-1]) * np.float32(0.5):
        x0 = np.float32(m * _A_SCALE)
        cands = [x0]
        lo = hi = x0
        for _ in range(16):
            lo = np.nextafter(lo, np.float32(-np.inf))
            hi = np.nextafter(hi, np.float32(np.inf))
            cands += [lo, hi]
        hits = [x for x in cands if np.float32(x * inv) == m]
        off = [x for x in hits if np.float32(x / _A_SCALE) != m]
        xs.append((off or hits or [x0])[0])
        found += bool(hits)
        split += bool(off)
    return np.float32(xs), found, split


@pytest.mark.parametrize("M", [1, 5, 300])
def test_w8a8_plain_bit_equal_to_pallas(M):
    rng = np.random.default_rng(M)
    a_q = int8_codebook(cb.ant_grid("flint", 4, True))[0].astype(np.float32)
    assert np.all(np.diff(a_q) >= 0)             # sorted (0 twice)
    w = rng.integers(-64, 65, (_K, _N)).astype(np.int8)
    out_scale = rng.uniform(1e-3, 3e-3, _N).astype(np.float32)
    x = (rng.normal(size=(M, _K)) * 8 * _A_SCALE).astype(np.float32)
    ties, found, split = _ties(a_q)
    x[0, :ties.shape[0]] = ties          # exact midpoints after x * inv
    assert found >= 10 and split >= 4    # the division would snap otherwise
    want = np.asarray(jk9(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a_q),
                          jnp.asarray(_A_SCALE), jnp.asarray(out_scale),
                          interpret=True))
    t = torch.from_numpy
    before = dict(tq.K9_COUNTS)
    got = tq.fused_w8a8_matmul(t(x), t(np.ascontiguousarray(w.T)), t(a_q),
                               torch.tensor(_A_SCALE), t(out_scale)).numpy()
    np.testing.assert_array_equal(got, want)
    # a CPU tensor takes the plain version, never the kernel
    assert tq.K9_COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert tq.K9_COUNTS["launches"] == before["launches"]


def test_w8a8_rejects_wide_codebooks():
    a_q = torch.arange(-8, 9, dtype=torch.float32)          # 17 entries
    with pytest.raises(ValueError, match="at most 16"):
        tq.fused_w8a8_matmul(torch.zeros(2, 16), torch.zeros(
            4, 16, dtype=torch.int8), a_q, torch.tensor(1.0),
            torch.ones(4))
