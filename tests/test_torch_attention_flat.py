"""PyTorch port vs the JAX reference: K7, causal attention of up to 16
queries over one layer's flat INT8 cache (plain version, the CPU path of
kernels/attention.py:int8_kv_attention), against the Pallas kernel in
interpret mode, with per-sequence start positions and with and without
ALiBi. Tolerances: atol 1e-4 at f32 output (the summation orders of the
two frameworks differ), atol 2e-2 + rtol 1e-2 at bf16 output (one bf16
step of the value, where an f32 difference rounds the other way)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels.attention import int8_kv_attention as jk7
from ant_quantization_tpu_torch.kernels import attention as tk

pytestmark = pytest.mark.torchdep

_B, _H, _S, _D = 2, 3, 40, 128
_SLOPES = np.float32([0.5, 0.25, 0.125])
_TOL = {"f32": (1e-4, 0.0), "bf16": (2e-2, 1e-2)}


def _cache(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (_B, _H, _S, _D)).astype(np.int8)
    v = rng.integers(-127, 128, (_B, _H, _S, _D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (_B, _H, _S)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (_B, _H, _S)).astype(np.float32)
    return k, v, ks, vs


@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_flat_attention_plain_matches_pallas(T, alibi, out):
    pos0 = [0, 23]                   # per sequence; 23 + 16 <= S
    k, v, ks, vs = _cache(seed=T)
    q = np.random.default_rng(5).normal(size=(_B, _H, T, _D)).astype(
        np.float32)
    p0 = np.int32(pos0)
    slopes = _SLOPES if alibi else None
    jdt, tdt = ((jnp.float32, torch.float32) if out == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jk7(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(p0),
        None if slopes is None else jnp.asarray(slopes),
        out_dtype=jdt, interpret=True).astype(jnp.float32))
    t = torch.from_numpy
    before = dict(tk.K7_COUNTS)
    got = tk.int8_kv_attention(
        t(q), t(k), t(v), t(ks), t(vs), t(p0),
        None if slopes is None else t(slopes), out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (_B, _H, T, _D)
    atol, rtol = _TOL[out]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    # a CPU tensor takes the plain version, never the kernel
    assert tk.K7_COUNTS["plain_calls"] == before["plain_calls"] + 1
    assert tk.K7_COUNTS["launches"] == before["launches"]


def test_flat_attention_equals_stacked_plain_on_a_layer():
    """K7's plain version on layer l's views is K2's plain version on the
    stacked cache, bit for bit (the same arithmetic on the same values)."""
    L, l = 2, 1
    parts = [_cache(seed=s) for s in (3, 4)]
    k, v, ks, vs = (torch.from_numpy(np.stack([p[i] for p in parts]))
                    for i in range(4))
    q = torch.from_numpy(np.random.default_rng(2).normal(
        size=(_B, _H, 5, _D)).astype(np.float32))
    p0 = torch.tensor([4, 30], dtype=torch.int32)
    slopes = torch.from_numpy(_SLOPES)
    got = tk.int8_kv_attention(q, k[l], v[l], ks[l], vs[l], p0, slopes,
                               out_dtype=torch.float32)
    want = tk.stacked_int8_kv_attention(l, q, k, v, ks, vs, p0, slopes,
                                        out_dtype=torch.float32)
    assert k.shape[0] == L and torch.equal(got, want)
