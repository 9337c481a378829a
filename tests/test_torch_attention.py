"""PyTorch port vs the JAX reference: K2, causal attention over the
stacked INT8 cache (plain version, the CPU path of kernels/attention.py),
against the Pallas kernel in interpret mode; atol 1e-5 in f32 (the
summation orders of the two frameworks differ)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.attention import (
    stacked_int8_kv_attention as jk2)
from ant_quantization_tpu_torch.kernels import attention as tk2

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

_SLOPES = np.float32([0.5, 0.25, 0.125])


def _stack(L, B, H, S, D, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (L, B, H, S)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (L, B, H, S)).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("T", [1, 6])
@pytest.mark.parametrize("pos0", [[0, 0], [13, 13], [2, 17]])
@pytest.mark.parametrize("alibi", [False, True])
def test_stacked_attention_plain_matches_pallas(T, pos0, alibi):
    L, B, H, S, D, l = 2, 2, 3, 24, 128, 1
    k, v, ks, vs = _stack(L, B, H, S, D, seed=T + sum(pos0))
    q = np.random.default_rng(9).normal(size=(B, H, T, D)).astype(np.float32)
    p0 = np.int32(pos0)
    slopes = _SLOPES if alibi else None
    want = np.asarray(jk2(
        jnp.int32(l), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(p0),
        None if slopes is None else jnp.asarray(slopes),
        out_dtype=jnp.float32, interpret=True))
    t = torch.from_numpy
    got = tk2.stacked_int8_kv_attention(
        l, t(q), t(k), t(v), t(ks), t(vs), t(p0),
        None if slopes is None else t(slopes),
        out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_oracle_agrees_with_plain_version():
    L, B, H, S, D, T, l = 2, 2, 3, 24, 128, 5, 0
    k, v, ks, vs = (torch.from_numpy(a) for a in _stack(L, B, H, S, D, 4))
    q = torch.from_numpy(
        np.random.default_rng(1).normal(size=(B, H, T, D)).astype(np.float32))
    p0 = torch.tensor([3, 11], dtype=torch.int32)
    slopes = torch.from_numpy(_SLOPES)
    got = tk2.stacked_int8_kv_attention_plain(
        l, q, k, v, ks, vs, p0, slopes, out_dtype=torch.float32)
    want = tk2.attention_oracle(q, k[l], v[l], ks[l], vs[l], p0, slopes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
