"""PyTorch port vs the JAX reference: the quantizer core's calibration
(ROADMAP Queue 1 item 9: ``calibrate/spec.py``, ``search.py``,
``promote.py``), on the inputs of the reference's
``tests/test_calibrate.py`` and ``test_outlier_mode.py``.

The search's scores are f32 means, which the two frameworks sum in other
orders, so two ratios (or two types) whose scores lie within a few ulps
could swap. Each case therefore first checks, on the reference's own
scores, that the chosen ratio of every channel and the chosen type win
by more than ``TIE`` relative; then:

- ANT states (absmax base, exact) bit-equal in alpha, grid, outliers,
  bit, type and signedness, their MSE (a mean) within 1e-6 relative;
- OliVe states with outliers: the 3-sigma base (a mean and a std)
  within 2 ulps, the same ratio per channel, the same type, bit and
  signedness;
- promotion over the port's tree as the reference's over its own.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate import promote as jpr
from ant_quantization_tpu.calibrate import search as jse
from ant_quantization_tpu.calibrate import spec as jsp
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.calibrate import promote as tpr
from ant_quantization_tpu_torch.calibrate import search as tse
from ant_quantization_tpu_torch.calibrate import spec as tsp

pytestmark = pytest.mark.torchdep


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tensors are tiny, and the suite's
    workers share the host's cores (many threads each spin on them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TIE = 1e-5
_FIELDS = ("alpha", "grid", "outliers", "bit", "mode_idx", "is_signed",
           "initialized", "aux")
ANT_W = dict(bit=4, mode="ant-int-pot-flint", family="ant", channel_axis=0)
OLIVE_W = dict(bit=4, mode="ant-int-flint", family="olive", w_up=250,
               a_up=250, scan_step=2, channel_axis=0)


def _x2(x, cfg):
    if cfg.per_channel:
        return jnp.moveaxis(x, cfg.channel_axis, 0).reshape(
            x.shape[cfg.channel_axis], -1)
    return x.reshape(-1)


def _assert_clear_of_ties(x, kw, promoted=False):
    """On the reference's scores: every channel's best ratio of the
    chosen type beats its runner-up, and the chosen type the next type,
    by more than TIE relative."""
    cfg = jsp.SiteConfig(**kw)
    xj = jnp.asarray(x)
    st = jse.calibrate(xj, cfg, promoted=jnp.asarray(promoted))
    bit = int(st.bit)
    modes = ("int",) if bit > 6 else cfg.candidate_modes
    low = 95 if (cfg.family == "ant" and bit > 6) else cfg.low
    x2 = _x2(xj, cfg)
    pc = cfg.per_channel
    base = jse._x_max(x2, cfg, pc)
    sidx = int(bool(st.is_signed))
    out = (jnp.asarray(jse._outlier_pair(bit))[sidx] if cfg.use_ovp
           else None)
    ratios = jnp.asarray(jse._ratio_ladder(low, cfg.up, cfg.scan_step),
                         jnp.float32)
    sums = []
    for m in modes:
        grid = jnp.asarray(jse._grid_pair(cfg, m, bit, True))[sidx]
        score = lambda r: jnp.mean(jnp.square(
            jse._fq(x2, grid, out, base * r, cfg, pc) - x2),
            axis=1 if pc else None)
        s = np.asarray(jax.jit(jax.vmap(score))(ratios))
        best = np.sort(s.reshape(s.shape[0], -1).astype(np.float64), axis=0)
        if jse.mode_index(m) == int(st.mode_idx):
            gap = (best[1] - best[0]) / best[0]
            assert gap.min() > TIE, (m, gap.min())
        sums.append(best[0].sum())
    return st


def _both(x, kw, **ck):
    jst = jse.calibrate_jit(jnp.asarray(x), jsp.SiteConfig(**kw),
                            **{k: jnp.asarray(v) for k, v in ck.items()})
    tst = tse.calibrate(torch.from_numpy(x), tsp.SiteConfig(**kw), **ck)
    return jst, tst


def _assert_ant_equal(jst, tst):
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)
    np.testing.assert_allclose(tst.mse.numpy(), np.asarray(jst.mse),
                               rtol=1e-6)


def _ratio_index(alpha, base, kw):
    cfg = tsp.SiteConfig(**kw)
    r = np.float32(tse._ratio_ladder(cfg.low, cfg.up, cfg.scan_step))
    a = np.asarray(alpha, np.float32).reshape(-1)
    b = np.asarray(base, np.float32).reshape(-1)
    return np.argmin(np.abs(a[:, None] - b[:, None] * r[None, :]), axis=1)


def _assert_olive_close(x, kw, jst, tst):
    """The 3-sigma base within 2 ulps, the same ratio per channel; the
    discrete fields equal."""
    cfg = tsp.SiteConfig(**kw)
    xt = torch.from_numpy(x)
    x2t = (torch.movedim(xt, cfg.channel_axis, 0).reshape(
        x.shape[cfg.channel_axis], -1) if cfg.per_channel else xt.reshape(-1))
    bt = tse._x_max(x2t, cfg, cfg.per_channel).numpy()
    bj = np.asarray(jse._x_max(_x2(jnp.asarray(x), jsp.SiteConfig(**kw)),
                               jsp.SiteConfig(**kw), cfg.per_channel))
    assert np.all(np.abs(bt - bj) <= 2 * np.spacing(np.abs(bj)))
    np.testing.assert_array_equal(_ratio_index(tst.alpha.numpy(), bt, kw),
                                  _ratio_index(jst.alpha, bj, kw))
    for f in ("grid", "outliers", "bit", "mode_idx", "is_signed"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)


def test_ant_weight_type_selection_and_alpha(rng):
    x = rng.normal(size=(8, 64)).astype(np.float32)
    _assert_clear_of_ties(x, ANT_W)
    _assert_ant_equal(*_both(x, ANT_W))


def test_ant_activation_per_tensor(rng):
    x = np.abs(rng.normal(size=(4, 32)).astype(np.float32))
    kw = dict(bit=4, mode="ant-int-pot-flint", family="ant", is_input=True,
              is_signed=False)
    _assert_clear_of_ties(x, kw)
    jst, tst = _both(x, kw)
    assert tst.alpha.shape == () and not bool(tst.is_signed)
    _assert_ant_equal(jst, tst)


def test_ant_signedness_flips_for_negative_input(rng):
    x = rng.normal(size=(4, 32)).astype(np.float32)
    kw = dict(bit=4, mode="ant-flint", family="ant", is_input=True,
              is_signed=False)
    _assert_clear_of_ties(x, kw)
    jst, tst = _both(x, kw)
    assert bool(tst.is_signed)
    _assert_ant_equal(jst, tst)


def test_ant_8bit_promotion_forces_int_and_95(rng):
    x = rng.normal(size=(8, 64)).astype(np.float32)
    _assert_clear_of_ties(x, ANT_W, promoted=True)
    jst, tst = _both(x, ANT_W, promoted=True)
    assert int(tst.bit) == 8 and int(tst.mode_idx) == tse.mode_index("int")
    _assert_ant_equal(jst, tst)


def test_apply_quant_bit_equal(rng):
    x = rng.normal(size=(8, 64)).astype(np.float32)
    jst, tst = _both(x, ANT_W)
    np.testing.assert_array_equal(
        tse.apply_quant(torch.from_numpy(x), tst,
                        tsp.SiteConfig(**ANT_W)).numpy(),
        np.asarray(jse.apply_quant(jnp.asarray(x), jst,
                                   jsp.SiteConfig(**ANT_W))))


def test_float_types_search_with_one_exponent_bit(rng):
    """float2..float4 are searched with one exponent bit and finalized
    with their own width, and the ladder runs again on the final grid."""
    x = rng.normal(size=(8, 64)).astype(np.float32)
    kw = dict(ANT_W, mode="ant-int-pot-float-float2-flint-apot")
    _assert_clear_of_ties(x, kw)
    _assert_ant_equal(*_both(x, kw))


def test_olive_weight_with_ovp(rng):
    x = rng.normal(size=(8, 64)).astype(np.float32)
    x[:, ::17] *= 10
    _assert_clear_of_ties(x, OLIVE_W)
    jst, tst = _both(x, OLIVE_W)
    assert float(tst.outliers.abs().max()) > 32
    _assert_olive_close(x, OLIVE_W, jst, tst)
    # the fake-quant of the same state is the reference's, bit for bit
    st = convert.from_jax_quant({"s": jst}, device="cpu")["s"]
    np.testing.assert_array_equal(
        tse.apply_quant(torch.from_numpy(x), st,
                        tsp.SiteConfig(**OLIVE_W)).numpy(),
        np.asarray(jse.apply_quant(jnp.asarray(x), jst,
                                   jsp.SiteConfig(**OLIVE_W))))


def test_olive_activation_per_tensor(rng):
    x = rng.normal(size=(4, 64)).astype(np.float32)
    x[:, ::13] *= 8
    kw = dict(OLIVE_W, is_input=True, is_signed=False, channel_axis=-1)
    _assert_clear_of_ties(x, kw)
    jst, tst = _both(x, kw)
    _assert_olive_close(x, kw, jst, tst)


def test_olive_no_outlier_absmax_init(rng):
    x = rng.normal(size=(8, 64)).astype(np.float32)
    kw = dict(OLIVE_W, no_outlier=True)
    _assert_clear_of_ties(x, kw)
    _assert_ant_equal(*_both(x, kw))


def test_olive_8bit_forces_int(rng):
    x = rng.normal(size=(4, 64)).astype(np.float32) * 4.0
    kw = dict(bit=8, mode="ant-int-flint", family="olive", no_outlier=True,
              channel_axis=0, scan_step=2, w_low=75, w_up=250)
    _assert_clear_of_ties(x, kw)
    jst, tst = _both(x, kw)
    assert int(tst.bit) == 8 and int(tst.mode_idx) == tse.mode_index("int")
    _assert_ant_equal(jst, tst)


def test_recalibration_pins_previous_adaptive_type():
    """``prev_mode`` pins the type of a recalibration even where the new
    batch prefers the other one (the reference's case)."""
    kw = dict(bit=4, is_input=True, is_signed=False, mode="ant-int-flint",
              family="olive", w_low=75, w_up=250, a_low=75, a_up=250,
              scan_step=2)
    rng = np.random.default_rng(0)
    x_uniform = rng.uniform(0, 1, (4, 64)).astype(np.float32)
    x_tailed = (rng.normal(size=(4, 64)) ** 3).astype(np.float32)
    u = tse.calibrate(torch.from_numpy(x_uniform), tsp.SiteConfig(**kw))
    t = tse.calibrate(torch.from_numpy(x_tailed), tsp.SiteConfig(**kw))
    assert int(u.mode_idx) != int(t.mode_idx)
    for prev in (int(u.mode_idx), -1):
        jst, tst = _both(x_tailed, kw, prev_mode=prev)
        want = int(u.mode_idx) if prev >= 0 else int(t.mode_idx)
        assert int(tst.mode_idx) == int(jst.mode_idx) == want
        _assert_olive_close(x_tailed, kw, jst, tst)


def test_gobo_outlier_mode_bit_equal(rng):
    x = rng.normal(size=(16, 32)).astype(np.float32)
    kw = dict(bit=4, mode="outlier", family="ant", percent=0.9,
              is_signed=True)
    jst, tst = _both(x, kw)
    _assert_ant_equal(jst, tst)
    np.testing.assert_array_equal(
        tse.apply_quant(torch.from_numpy(x), tst,
                        tsp.SiteConfig(**kw)).numpy(),
        np.asarray(jse.apply_quant(jnp.asarray(x), jst,
                                   jsp.SiteConfig(**kw))))


def test_spec_pieces():
    g = np.linspace(-1, 1, 16).astype(np.float32)
    np.testing.assert_array_equal(tsp.pad_grid(g), jsp.pad_grid(g))
    for c in (None, 12):
        j, t = jsp.placeholder_state(c), tsp.placeholder_state(c, "cpu")
        for f in _FIELDS + ("mse",):
            a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a)
    st = tsp.placeholder_state(4, "cpu")
    up = st.replace(bit=torch.tensor(8, dtype=torch.int32))
    assert int(up.bit) == 8 and int(st.bit) == 0
    assert set(st.numpy()) == {f.name for f in dataclasses.fields(st)}
    sc = tsp.SiteConfig(mode="ant-int-pot-float-flint")
    assert sc.candidate_modes == jsp.SiteConfig(
        mode="ant-int-pot-float-flint").candidate_modes


def _tree(n_layers=11):
    """A quant collection over h_0..h_10 (natural order: h_10 last), each
    site's MSE distinct."""
    rng = np.random.default_rng(7)
    tree = {}
    for i in range(n_layers):
        layer = {}
        for site in ("fc_in", "fc_out"):
            st = jsp.placeholder_state(4).replace(
                mse=jnp.float32(rng.uniform(0.1, 1.0)),
                bit=jnp.int32(4), initialized=jnp.asarray(True))
            layer[site] = {"weight_q": st,
                           "input_q": st.replace(
                               mse=jnp.float32(rng.uniform(0.1, 1.0)))}
        tree[f"h_{i}"] = layer
    return tree


@pytest.mark.parametrize("how", ["n3", "n7", "list", "no_list"])
def test_promotion_matches_reference(how):
    jtree = _tree()
    ttree = convert.from_jax_quant(jtree, device="cpu")
    assert [p for p, _ in tpr.quant_sites(ttree)] == [
        p for p, _ in jpr.quant_sites(jtree)]
    if how in ("n3", "n7"):
        jt = jpr.set_8_bit_layer_n(jtree, int(how[1:]))
        tt = tpr.set_8_bit_layer_n(ttree, int(how[1:]))
    else:
        arg = "0,5,12" if how == "list" else "None"
        jt = jpr.set_8_bit_layer_l(jtree, arg)
        tt = tpr.set_8_bit_layer_l(ttree, arg)
    assert tpr.promoted_site_paths(tt) == jpr.promoted_site_paths(jt)
    for (jp, js), (tp, ts) in zip(jpr.quant_sites(jt), tpr.quant_sites(tt)):
        assert jp == tp
        for k in ("weight_q", "input_q"):
            for f in ("bit", "initialized", "mse"):
                np.testing.assert_array_equal(
                    getattr(ts[k], f).numpy(), np.asarray(getattr(js[k], f)))
