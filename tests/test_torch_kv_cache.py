"""PyTorch port vs the JAX reference: INT8 KV quantize, stacked append
and dequantize. Codes and scales are compared bit-equal by position (the
reference's lane-folded layout is unfolded by convert.from_jax_kv)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.kernels import kv_cache as jkv
from ant_quantization_tpu_torch.convert import from_jax_kv
from ant_quantization_tpu_torch.kernels import kv_cache as tkv

pytestmark = pytest.mark.torchdep


def test_quantize_bit_equal_with_zero_rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 7, 64)).astype(np.float32) * 3
    x[1, 2, 3] = 0.0                     # absmax 0 -> scale 1.0
    want_q, want_s = jkv._quantize(jnp.asarray(x))
    got_q, got_s = tkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[1, 2, 3] == 1.0


@pytest.mark.parametrize("head_dim", [128, 64])     # reference fold 1, 2
@pytest.mark.parametrize("T,index", [(1, 6), (5, 3), (5, 0)])
def test_append_stacked_bit_equal_by_position(head_dim, T, index):
    L, B, H, S, layer = 2, 2, 3, 12, 1
    rng = np.random.default_rng(head_dim + T + index)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (L,) + a.shape),
        jkv.init_kv(B, S, H, head_dim))
    tcache = tkv.init_kv(L, B, S, H, head_dim, torch.device("cpu"))
    # two writes: the earlier positions must survive the later one
    for idx, t in ((0, index), (index, T)):
        if t == 0:
            continue
        k = rng.normal(size=(B, t, H, head_dim)).astype(np.float32)
        v = rng.normal(size=(B, t, H, head_dim)).astype(np.float32) * 2
        jcache = jkv.append_kv_stacked(jcache, jnp.asarray(k),
                                       jnp.asarray(v), layer, idx)
        tkv.append_kv_stacked(tcache, torch.from_numpy(k),
                              torch.from_numpy(v), layer, idx)
    want = from_jax_kv([np.asarray(a) for a in jcache], head_dim, "cpu")
    for g, w in zip(tcache, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    jk, jv = jkv.dequant_kv(jkv.QuantKV(*(a[layer] for a in jcache)),
                            jnp.float32)
    tk, tv = tkv.dequant_kv(tkv.QuantKV(*(a[layer] for a in tcache)),
                            torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("head_dim,T", [(128, 5), (64, 1)])  # fold 1, 2
def test_append_stacked_per_sequence_bit_equal_by_position(head_dim, T):
    """A (B,) write index: sequence b's rows go to index[b] .. index[b]+T-1
    (the reference's vector-index write), after a shared prefill write."""
    L, B, H, S, layer = 2, 3, 2, 16, 1
    rng = np.random.default_rng(head_dim + T)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (L,) + a.shape),
        jkv.init_kv(B, S, H, head_dim))
    tcache = tkv.init_kv(L, B, S, H, head_dim, torch.device("cpu"))
    index = np.int32([7, 2, 11])
    for idx, t in ((0, 6), (index, T)):
        k = rng.normal(size=(B, t, H, head_dim)).astype(np.float32)
        v = rng.normal(size=(B, t, H, head_dim)).astype(np.float32) * 2
        jcache = jkv.append_kv_stacked(jcache, jnp.asarray(k),
                                       jnp.asarray(v), layer,
                                       jnp.asarray(idx))
        tkv.append_kv_stacked(tcache, torch.from_numpy(k),
                              torch.from_numpy(v), layer,
                              torch.from_numpy(np.asarray(idx)) if t == T
                              else idx)
    want = from_jax_kv([np.asarray(a) for a in jcache], head_dim, "cpu")
    for g, w in zip(tcache, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_append_past_the_end_raises():
    cache = tkv.init_kv(1, 1, 4, 1, 8, torch.device("cpu"))
    x = torch.zeros(1, 3, 1, 8)
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 0, 2)
    # per sequence: one sequence past the end is enough
    cache = tkv.init_kv(1, 2, 4, 1, 8, torch.device("cpu"))
    x = torch.zeros(2, 2, 1, 8)
    with pytest.raises(ValueError):
        tkv.append_kv_stacked(cache, x, x, 0, torch.tensor([0, 3]))
