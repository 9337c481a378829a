"""PyTorch port vs the JAX reference: the quantizer ops (ROADMAP Queue 1
item 6), on the inputs of the reference's own tests
(``tests/test_codebooks.py``, ``test_snap.py``, ``test_fake_quant.py``,
``test_outlier_mode.py``, ``test_affine.py``):

- ``numerics/codebooks.py``: ``ANT_MODES``, ``grid_size`` and every grid
  equal;
- ``ops/snap.py``: ``snap_uniform`` and the ``snap_bruteforce`` oracle
  bit-equal, ties included; the binary-search snaps that the fake-quants
  use bit-equal to the reference's select chains;
- ``ops/fake_quant.py``: values bit-equal (per tensor, per channel,
  OliVe with OVP, sized and promoted grids); STE gradients equal to
  ``jax.grad``: x bit for bit, alpha within 1e-6 of the sum of its
  terms' magnitudes (one sum of 64 terms that nearly cancel, in another
  order);
- ``ops/outlier.py``: thresholds and fake-quant bit-equal to the
  reference's jitted calibration, which folds the percentile position
  and contracts its combine (see the module);
- ``ops/affine.py``: values bit-equal, the straight-through gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate.spec import pad_grid
from ant_quantization_tpu.numerics import codebooks as jcb
from ant_quantization_tpu.ops import affine as ja
from ant_quantization_tpu.ops import fake_quant as jf
from ant_quantization_tpu.ops import outlier as jo
from ant_quantization_tpu.ops import snap as js
from ant_quantization_tpu_torch.numerics import codebooks as tcb
from ant_quantization_tpu_torch.ops import affine as ta
from ant_quantization_tpu_torch.ops import fake_quant as tf
from ant_quantization_tpu_torch.ops import outlier as to
from ant_quantization_tpu_torch.ops import snap as ts

pytestmark = pytest.mark.torchdep


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the suite's
    workers share the host's cores (many threads each spin on them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

T = torch.from_numpy
J = jnp.asarray


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_codebook_tables():
    assert tcb.ANT_MODES == jcb.ANT_MODES
    for bit in (2, 4, 6, 8):
        assert tcb.grid_size(bit) == jcb.grid_size(bit)
    for mode in jcb.ANT_MODES:
        for bit in (4, 6, 8):
            for signed in (True, False):
                try:
                    want = jcb.ant_grid(mode, bit, signed)
                except ValueError:
                    with pytest.raises(ValueError):
                        tcb.ant_grid(mode, bit, signed)
                    continue
                np.testing.assert_array_equal(
                    tcb.ant_grid(mode, bit, signed), want)


def _snap_grids():
    for mode in ("int", "pot", "float", "flint", "apot"):
        for signed in (True, False):
            yield jcb.ant_grid(mode, 4, signed)
    yield jcb.olive_int_values(4, True)
    yield jcb.olive_flint_values(4, True)
    yield jcb.ant_grid("pot", 6, False)
    yield jcb.ant_grid("int", 8, True)
    yield pad_grid(jcb.ant_grid("flint", 4, False), 32)   # duplicate max


def test_search_snap_and_bruteforce_bit_equal(rng):
    """``snap_value_search`` against the reference's ``snap_value`` select
    chain (exact midpoint ties too) and ``snap_bruteforce`` (values and
    codes) against the reference's oracle."""
    for grid in _snap_grids():
        x = np.concatenate([rng.normal(size=1024) * 12,
                            (grid[1:] + grid[:-1]) / 2]).astype(np.float32)
        _eq(ts.snap_value_search(T(x), T(grid)),
            js.snap_value(J(x), J(grid)))
        bv, bc = js.snap_bruteforce(J(x), J(grid))
        tv, tc = ts.snap_bruteforce(T(x), T(grid))
        _eq(tv, bv)
        _eq(tc, bc)


def test_concat_search_snap_bit_equal(rng):
    """OliVe's unsorted concat: the tie toward the later entry (+40 ->
    48, -40 -> -48), padded duplicates, signed and unsigned."""
    for grid in (np.concatenate([jcb.olive_grid("flint", 4, True),
                                 jcb.olive_outlier_values(4, True)]),
                 np.concatenate([pad_grid(jcb.olive_grid("int", 4, True),
                                          16),
                                 pad_grid(jcb.olive_outlier_values(4, True),
                                          16)]),
                 np.concatenate([jcb.olive_grid("int", 4, False),
                                 pad_grid(jcb.olive_outlier_values(4, False),
                                          16)])):
        sg = np.sort(grid)
        x = np.concatenate([rng.normal(size=8192) * 64,
                            (sg[1:] + sg[:-1]) / 2,
                            [40.0, -40.0, 32.0, -32.0, 400.0]]).astype(
                                np.float32)
        _eq(ts.snap_concat_value_search(T(x), T(grid)),
            js.snap_concat_value(J(x), J(grid)))


def test_snap_uniform_bit_equal():
    rng = np.random.default_rng(0)
    for G in (16, 256):
        grid = (np.float32(-3.0) + np.float32(0.0471)
                * np.arange(G, dtype=np.float32))
        x = (rng.normal(size=1000) * 8).astype(np.float32)
        for size in (None, G):
            wv, wc = js.snap_uniform(J(x), J(grid), size)
            tv, tc = ts.snap_uniform(T(x), T(grid), size)
            _eq(tv, wv)
            _eq(tc, wc)
    rng = np.random.default_rng(1)
    for bit, signed in ((8, True), (7, True), (7, False), (8, False)):
        real = jcb.olive_int_values(bit, signed).astype(np.float32)
        padded = pad_grid(real)
        x = np.concatenate([rng.normal(size=500) * np.max(np.abs(real)),
                            [0.0, real[0], real[-1]]]).astype(np.float32)
        wv, wc = js.snap_uniform(J(x), J(padded))
        tv, tc = ts.snap_uniform(T(x), T(padded))
        _eq(tv, wv)
        _eq(tc, wc)


def test_ant_fake_quant_bit_equal(rng):
    grid = jcb.ant_grid("flint", 4, True)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    _eq(tf.ant_fake_quant(T(x), T(grid), torch.tensor(2.5)),
        jf.ant_fake_quant(J(x), J(grid), np.float32(2.5)))
    grid = jcb.ant_grid("int", 4, True)
    x = rng.normal(size=(16, 9, 3)).astype(np.float32) * 3
    alpha = np.abs(x).reshape(16, -1).max(1).astype(np.float32)
    _eq(tf.ant_fake_quant(T(x), T(grid), T(alpha), channel_axis=0),
        jf.ant_fake_quant(J(x), J(grid), J(alpha), channel_axis=0))


@pytest.mark.parametrize("dyn_bit", [4, 8])
def test_sized_snap_and_promotion_bit_equal(dyn_bit):
    """A 4-bit site's padded storage grid: the first 16 entries, or, for a
    state promoted to 8 bits, the uniform snap of the 8-bit int grid."""
    rng = np.random.default_rng(dyn_bit)
    g = jcb.ant_grid("flint" if dyn_bit == 4 else "int", dyn_bit, True)
    grid = pad_grid(g)
    x = rng.normal(size=(8, 64)).astype(np.float32) * 3
    alpha = np.float32(4.0)
    want = jf.ant_fake_quant(J(x), J(grid), alpha, static_bit=4,
                             dyn_bit=jnp.int32(dyn_bit))
    _eq(tf.ant_fake_quant(T(x), T(grid), torch.tensor(alpha), static_bit=4,
                          dyn_bit=torch.tensor(dyn_bit)), want)
    og = pad_grid(jcb.olive_grid("int", dyn_bit, True))
    out = pad_grid(jcb.olive_outlier_values(dyn_bit, True))
    want = jf.olive_fake_quant(J(x), J(og), J(out), alpha, pair_axis=-1,
                               static_bit=4, dyn_bit=jnp.int32(dyn_bit))
    _eq(tf.olive_fake_quant(T(x), T(og), T(out), torch.tensor(alpha),
                            pair_axis=-1, static_bit=4,
                            dyn_bit=torch.tensor(dyn_bit)), want)


def test_olive_fake_quant_bit_equal(rng):
    grid = jcb.olive_flint_values(4, True)
    outliers = jcb.olive_outlier_values(4, True)
    x = rng.normal(size=1024).astype(np.float32)
    x[::100] *= 40
    alpha = np.float32(np.abs(x).mean() * 3)
    _eq(tf.olive_fake_quant(T(x), T(grid), T(outliers), torch.tensor(alpha)),
        jf.olive_fake_quant(J(x), J(grid), J(outliers), alpha))
    # per channel, pairs along the other axis; and the no-outlier mode
    x2 = rng.normal(size=(8, 32)).astype(np.float32)
    x2[:, ::7] *= 12
    a2 = (np.abs(x2).max(1) * 0.4).astype(np.float32)
    _eq(tf.olive_fake_quant(T(x2), T(grid), T(outliers), T(a2),
                            channel_axis=0, pair_axis=1),
        jf.olive_fake_quant(J(x2), J(grid), J(outliers), J(a2),
                            channel_axis=0, pair_axis=1))
    _eq(tf.olive_fake_quant(T(x2), T(grid), None, torch.tensor(3.0)),
        jf.ant_fake_quant(J(x2), J(grid), jnp.float32(3.0)))


def test_ste_gradients_equal_jax_grad(rng):
    """d/dx is the straight-through 1 (times the chain rule of the sum of
    squares, bit for bit); d/dalpha flows through the scale, equal to
    jax.grad within 1e-6 relative."""
    g = jcb.ant_grid("flint", 4, True)
    x = rng.normal(size=64).astype(np.float32)
    f_j = lambda x, a: jnp.sum(jf.ant_fake_quant(x, J(g), a) ** 2)
    jx = jax.grad(f_j, argnums=0)(J(x), jnp.float32(2.0))
    ja_ = jax.grad(f_j, argnums=1)(J(x), jnp.float32(2.0))
    xt = T(x.copy()).requires_grad_()
    at = torch.tensor(2.0, requires_grad=True)
    (tf.ant_fake_quant(xt, T(g), at) ** 2).sum().backward()
    _eq(xt.grad, jx)
    # one sum of 64 terms that nearly cancel, in another order: held
    # within 1e-6 of the sum of the terms' magnitudes (here the gradient
    # itself is -2.07, the sum of the magnitudes 7.63)
    jac = torch.autograd.functional.jacobian(
        lambda a: tf.ant_fake_quant(T(x), T(g), a), torch.tensor(2.0))
    out = tf.ant_fake_quant(T(x), T(g), torch.tensor(2.0))
    size = (2 * out * jac).abs().sum().item()
    assert abs(at.grad.item() - float(ja_)) <= 1e-6 * size
    # the plain STE: d sum(out) / dx == 1
    xt = T(x.copy()).requires_grad_()
    tf.ant_fake_quant(xt, T(g), torch.tensor(2.0)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones(64, np.float32))


@pytest.mark.parametrize("n,percent", [(512, 0.95), (1000, 0.9),
                                       (12345, 0.999), (777, 0.5),
                                       (64, 1.0), (64, 0.0)])
def test_outlier_thresholds_bit_equal(n, percent):
    """Against the reference's thresholds as its jitted calibration
    computes them (``percent`` a constant there)."""
    x = (np.random.default_rng(n).normal(size=n) * 3).astype(np.float32)
    jt4, jt16 = jax.jit(lambda a: jo.outlier_thresholds(a, percent))(J(x))
    t4, t16 = to.outlier_thresholds(T(x), percent)
    assert t4.item() == float(jt4) and t16.item() == float(jt16)


def test_outlier_fake_quant_bit_equal(rng):
    x = rng.normal(size=512).astype(np.float32) * 3
    grid = jcb.ant_grid("int", 4, True)
    for percent, signed in ((0.95, True), (0.9, False), (1.0, True)):
        t4, t16 = to.outlier_thresholds(T(x), percent)
        _eq(to.outlier_fake_quant(T(x), T(grid), t4, t16, percent,
                                  torch.tensor(signed)),
            jo.outlier_fake_quant(J(x), J(grid), J(t4.numpy()),
                                  J(t16.numpy()), percent,
                                  jnp.asarray(signed)))


def test_affine_bit_equal_and_ste():
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 5, (1000,)).astype(np.float32)
    for bits in (4, 8, 16):
        _eq(ta.fake_affine_quantize(T(x), bits),
            ja.fake_affine_quantize(J(x), bits))
    _eq(ta.fake_affine_quantize(torch.full((8,), 2.5), 4),
        ja.fake_affine_quantize(jnp.full((8,), 2.5), 4))
    xt = torch.tensor([0.1, -0.7, 2.3], requires_grad=True)
    ta.ste_affine_quantize(xt, 4).sum().backward()
    jg = jax.grad(lambda v: ja.ste_affine_quantize(v, 4).sum())(
        jnp.asarray([0.1, -0.7, 2.3]))
    _eq(xt.grad, jg)
