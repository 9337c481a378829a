"""PyTorch port vs the JAX reference: the OliVe numerics. The OliVe
codebooks, the outlier-victim pairs, the unsorted-concat snap with its tie
rule and padded duplicates, the sign-offset OVP encoding and the OVP
weight packer are bit-equal to the reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ant_quantization_tpu.kernels import qmatmul as jq
from ant_quantization_tpu.numerics import codebooks as jcb
from ant_quantization_tpu.ops import ovp as jovp
from ant_quantization_tpu.ops import snap as jsnap
from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.numerics import codebooks as tcb
from ant_quantization_tpu_torch.ops import ovp as tovp
from ant_quantization_tpu_torch.ops import snap as tsnap

pytestmark = pytest.mark.torchdep


def _pad16(a):
    """A grid padded to 16 by repeating its last entry, as calibration
    stores it."""
    return np.pad(a, (0, 16 - a.shape[0]), mode="edge").astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("bit", [3, 4, 5, 6])
@pytest.mark.parametrize("signed", [True, False])
def test_olive_codebooks_bit_equal(bit, signed):
    for mode in ("int", "flint"):
        np.testing.assert_array_equal(
            _bits(tcb.olive_grid(mode, bit, signed)),
            _bits(jcb.olive_grid(mode, bit, signed)))
    np.testing.assert_array_equal(
        _bits(tcb.olive_outlier_values(bit, signed)),
        _bits(jcb.olive_outlier_values(bit, signed)))
    np.testing.assert_array_equal(
        _bits(tcb.olive_flint_values(bit, signed, exp_base=1)),
        _bits(jcb.olive_flint_values(bit, signed, exp_base=1)))


@pytest.mark.parametrize("axis", [0, -1, 1])
def test_victim_mask_and_apply_ovp(axis):
    rng = np.random.default_rng(abs(axis) + 3)
    q = (rng.normal(size=(6, 8, 4)) * 30).astype(np.float32)
    # both members of some pairs are outliers
    q[0, :2, 0] = [40.0, -50.0]
    q[1, 0, :2] = [-60.0, 33.0]
    m = np.abs(q) > 32
    np.testing.assert_array_equal(
        tovp.victim_mask(torch.from_numpy(m), axis).numpy(),
        np.asarray(jovp.victim_mask(jnp.asarray(m), axis)))
    got = tovp.apply_ovp(torch.from_numpy(q), axis).numpy()
    want = np.asarray(jovp.apply_ovp(jnp.asarray(q), axis))
    np.testing.assert_array_equal(_bits(got), _bits(want))   # -0.0 too


def _concat_inputs(signed, seed):
    g = _pad16(tcb.olive_grid("flint", 4, signed))
    o = _pad16(tcb.olive_outlier_values(4, signed))
    full = np.concatenate([g, o])
    order = np.argsort(full, kind="stable")
    sg = full[order]
    mids = (sg[1:] + sg[:-1]) * np.float32(0.5)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 64)) * 80).astype(np.float32)
    # every midpoint exactly (ties both ways, the padded duplicates'
    # equal "midpoints"), and every entry itself
    x[0, :31] = mids
    x[1, :32] = full
    if not signed:
        x = np.abs(x)
    return x, full


@pytest.mark.parametrize("signed", [True, False])
def test_snap_concat_bit_equal(signed):
    x, full = _concat_inputs(signed, 7)
    tv, tc = tsnap.snap_concat(torch.from_numpy(x), torch.from_numpy(full))
    jv, jc = jsnap.snap_concat(jnp.asarray(x), jnp.asarray(full))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    got = tsnap.snap_concat_value(torch.from_numpy(x), torch.from_numpy(full))
    want = jsnap.snap_concat_value(jnp.asarray(x), jnp.asarray(full))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # and the sorted-grid snap with codes
    g = np.sort(full)
    tv, tc = tsnap.snap(torch.from_numpy(x), torch.from_numpy(g))
    jv, jc = jsnap.snap(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))


@pytest.mark.parametrize("mode", ["int", "flint"])
@pytest.mark.parametrize("signed", [True, False])
def test_ovp_unit_and_encode_decode(mode, signed):
    g = _pad16(tcb.olive_grid(mode, 4, signed))
    o = _pad16(tcb.olive_outlier_values(4, signed))
    u, exact = tq.ovp_unit(g, o)
    assert (u, exact) == jq.ovp_unit(g, o)
    assert exact
    thr = float(np.max(np.abs(g)))
    for v in np.unique(np.concatenate([g, o, [0.0]])):
        assert tq.ovp_encode_scalar(v, u, thr) == \
            jq.ovp_encode_scalar(v, u, thr)
    c = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    np.testing.assert_array_equal(tq.ovp_clip(torch.from_numpy(c)).numpy(),
                                  np.asarray(jq.ovp_clip(jnp.asarray(c))))
    got = tq.ovp_decode_values(torch.from_numpy(c))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq.ovp_decode_values(jnp.asarray(c))))


def test_ovp_unit_inexact_grid():
    g = _pad16(tcb.olive_grid("flint", 4, True))
    o = _pad16(tcb.olive_outlier_values(4, True)) * np.float32(1.1)
    assert tq.ovp_unit(g, o) == jq.ovp_unit(g, o)
    assert not tq.ovp_unit(g, o)[1]


@pytest.mark.parametrize("mode", ["int", "flint"])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_weights_ovp_i8_bit_equal(mode, signed):
    rng = np.random.default_rng(11 + signed)
    K, N = 64, 24
    w = rng.normal(size=(K, N)).astype(np.float32)
    if not signed:
        w = np.abs(w)
    grid = _pad16(tcb.olive_grid(mode, 4, signed))
    out = _pad16(tcb.olive_outlier_values(4, signed))
    alpha = (2.5 * w.std(0)).astype(np.float32)       # ~1% outliers
    te, ts = tq.quantize_weights_ovp_i8(torch.from_numpy(w), grid, out,
                                        alpha)
    je, js = jq.quantize_weights_ovp_i8(jnp.asarray(w), jnp.asarray(grid),
                                        jnp.asarray(out), jnp.asarray(alpha))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    assert (np.abs(te.numpy()) > 64).any(), "no outliers were encoded"
    # a scalar alpha broadcasts over the channels
    te, ts = tq.quantize_weights_ovp_i8(torch.from_numpy(w), grid, out,
                                        np.float32(1.5))
    je, js = jq.quantize_weights_ovp_i8(jnp.asarray(w), jnp.asarray(grid),
                                        jnp.asarray(out),
                                        jnp.asarray(np.float32(1.5)))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


def test_quantize_weights_ovp_i8_refuses():
    g = _pad16(tcb.olive_grid("flint", 4, True))
    o = _pad16(tcb.olive_outlier_values(4, True))
    w = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="no exact sign-offset OVP unit"):
        tq.quantize_weights_ovp_i8(w, g, o * np.float32(1.1), 1.0)
    with pytest.raises(ValueError, match="axis must be 0 or 1"):
        tq.quantize_weights_ovp_i8(w, g, o, 1.0, pair_axis=1, axis=2)
