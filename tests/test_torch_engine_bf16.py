"""PyTorch port vs the JAX reference at ``cfg.dtype`` bf16, the dtype that
every chip run serves. In two parts:

- each step alone, on the same bf16 inputs as its JAX function: ``_ln``,
  ``_act`` (relu and gelu), the int8 and the plain head, and each site
  route (K1's plain version, the unfused ``_int_mm`` route, the w4pack
  route through K8's plain version, the fake-quant route). Bit-equal
  where the arithmetic is the same; otherwise within the bound each test
  states and explains;
- the whole 2-layer OPT engine of ``test_torch_engine.py`` and the 2-layer
  BLOOM engine of ``test_torch_engine_bloom.py`` (GELU) against JAX
  ``forward`` at bf16.

Why the whole-engine bound is loose: in bf16 one rounding step is 2^-8 of
a value, and a one-ulp difference upstream (``_ln``'s variance and rsqrt
steps, below) moves A4 snaps and int8-KV codes downstream. No model seed
is clear of those edges at bf16: on OPT seed 0 the reference's own bf16
logits differ from its f32 logits by a median of 0.76 and at most 6.9
(logits up to 220), as much as the port's bf16 logits differ from the
reference's. So the engines are held to that noise level (``_ENGINE_TOL``)
and to the same greedy token at every position.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.models.transformer_lm import LMConfig as JLMConfig
from ant_quantization_tpu.serve import engine as jeng
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.kernels import qmatmul as tq
from ant_quantization_tpu_torch.kernels import stacked as tk
from ant_quantization_tpu_torch.models.transformer_lm import LMConfig
from ant_quantization_tpu_torch.serve import engine as teng

import test_torch_engine as opt
import test_torch_engine_bloom as bloom
import test_torch_w4pack as w4p

pytestmark = pytest.mark.torchdep

_BF = torch.bfloat16
# whole engines: median and largest |logit difference| over the largest
# |logit| of the call (measured over prefill and 3 decode steps at model
# seeds 0-5 of both engines: medians up to 0.015, largest up to 0.073)
_ENGINE_TOL = (0.02, 0.1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(a: np.ndarray):
    """The same bf16 values for both frameworks."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(_BF)


def _f(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 step at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_gelu_bf16_returns_f32_as_the_reference():
    """F1: the reference's constant is a strongly typed f32, so its bf16
    GELU returns f32. Up to the tanh every step is bit-equal; the tanh
    itself is XLA:CPU's rational approximation there and torch's here,
    which differ by up to 4 f32 ulps, so the result is held within
    2^-20 |x| (4 ulps of tanh, times x / 2, plus the product's rounding)."""
    j1, t1 = _pair(np.float32([1.5]))
    got = teng._act("gelu", t1)
    assert got.dtype == torch.float32
    assert got.item() == np.float32(1.3992008) == np.asarray(
        jeng._act("gelu", j1))[0]
    x = 3 * np.random.default_rng(0).normal(size=(80, 256))
    jx, tx = _pair(x)
    want = np.asarray(jeng._act("gelu", jx))
    got = teng._act("gelu", tx)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # the bf16 inner x + 0.044715 x^3, bit for bit
    j_inner = _f(jx + 0.044715 * jnp.power(jx, 3.0))
    t_inner = _f(tx + torch.tensor(0.044715).to(_BF)
                 * torch.pow(tx.float(), 3.0).to(_BF))
    np.testing.assert_array_equal(t_inner, j_inner)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= 2.0 ** -20 * np.abs(_f(tx))).all(), err.max()


def test_relu_bf16_bit_equal():
    jx, tx = _pair(np.random.default_rng(1).normal(size=(80, 256)))
    got = teng._act("relu", tx)
    assert got.dtype == _BF
    np.testing.assert_array_equal(_f(got), _f(jeng._act("relu", jx)))


def test_ln_bf16_within_two_steps():
    """``_ln`` at bf16: the mean and the squares are bit-equal, but the
    variance's f32 sum and the rsqrt differ by one bf16 step in some rows
    (XLA:CPU's sum order and rsqrt against torch's), which moves the
    normalised term (x - mu) rsqrt(var) scale of those rows by up to two
    bf16 steps of it, before the bias; the sum then rounds once more."""
    rng = np.random.default_rng(2)
    jx, tx = _pair(2 * rng.normal(size=(80, 256)) + 0.3)
    sc = (1 + 0.1 * rng.normal(size=256)).astype(np.float32)
    bi = (0.1 * rng.normal(size=256)).astype(np.float32)
    want = _f(jeng._ln(jx, {"scale": jnp.asarray(sc),
                            "bias": jnp.asarray(bi)}, 1e-5))
    got = teng._ln(tx, torch.from_numpy(sc), torch.from_numpy(bi), 1e-5)
    assert got.dtype == _BF
    err = np.abs(_f(got) - want)
    bound = 2 * _bf16_ulp(want - bi) + _bf16_ulp(want)
    assert (err <= bound).all(), (err / bound).max()
    assert 0 < (err > 0).mean() < 0.5          # the rows that differ


def test_heads_bf16():
    """F2: the plain head is an f32 product of the bf16 operands (the
    reference's ``preferred_element_type=f32``), so it agrees with the
    reference up to the f32 sum order: within 1e-5 of |x| @ |wte|. The
    int8 head is bit-equal."""
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(2, 3, 64)))
    jw, tw = _pair(rng.normal(size=(100, 64)))
    want = np.asarray(jeng._lm_logits({"wte": jw}, jx))
    got = teng._lm_logits({"wte": tw}, tx)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 100)
    size = np.abs(_f(tx)).astype(np.float64) @ np.abs(_f(tw)).T
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-5 * size).all(), (err / size).max()
    w = rng.normal(size=(100, 64)).astype(np.float32)
    jtop = jeng.quantize_lm_head(jnp.asarray(w))
    ttop = teng.quantize_lm_head(torch.from_numpy(w))
    np.testing.assert_array_equal(
        teng._lm_logits(ttop, tx).numpy(),
        np.asarray(jeng._lm_logits(jtop, jx)))


@functools.lru_cache(maxsize=None)
def _w4_engines(weight_mode):
    """The w4pack test's "unfused" model (int grids at q/k/v, flint
    elsewhere, a pot activation grid without an int8-exact codebook at
    fc_out) at bf16, built by both frameworks."""
    kw = dict(weight_mode=weight_mode, act_bits=4, kv_int8=True,
              lm_head_int8=True, max_seq=96)
    jcfg = jeng.EngineConfig(lm=JLMConfig(**w4p._GEOM), dtype=jnp.bfloat16,
                             interpret=True, **kw)
    tcfg = teng.EngineConfig(lm=LMConfig(**w4p._GEOM), dtype=_BF, **kw)
    params, quant = w4p._model("unfused", seed=4)
    jep = jeng.build_engine_params(jcfg, params, quant)
    tep = teng.build_engine_params(tcfg, params, quant, device="cpu")
    return jcfg, tcfg, jep, tep


def _site(jep, name, l):
    return jax.tree_util.tree_map(lambda a: a[l], jep["layers"][name])


@pytest.mark.parametrize("route", ["k1_plain", "int_mm", "fake_quant",
                                   "w4pack"])
def test_site_routes_bf16(route):
    """One site route at a time on the same bf16 activations (M = 2 for
    K1, M = 80 for the others): K1's plain version and the ``_int_mm``
    route bit-equal (integer-exact products, the same f32 steps); the
    fake-quant route (bf16 snap, an f32 product of bf16 operands) and the
    w4pack route (the fake-quant in bf16, then K8's f32 product) within
    2 K 2^-24 of each output's sum of term magnitudes, the f32 sum
    order."""
    jcfg, tcfg, jep, tep = _w4_engines("w4pack" if route == "w4pack"
                                       else "w4")
    name = {"k1_plain": "q", "int_mm": "q", "fake_quant": "fc_out",
            "w4pack": "fc_out"}[route]
    K = w4p._SITES[name][0]
    M = 2 if route == "k1_plain" else 80
    rng = np.random.default_rng(5)
    for l in range(2):
        jx, tx = _pair(np.abs(rng.normal(size=(M, K)) * 1.5))
        site = _site(jep, name, l)
        if route == "k1_plain":
            jstk = jeng._prepare_stacked(jcfg, jep, M)
            assert jstk is None            # fc_out has no a_q: all or nothing
            s = tep["layers"][name]
            before = tk.COUNTS["plain_calls"]
            got = tk.stacked_quant_matmul(
                l, tx, s["w_i8"], s["a_scale"][:, None] * s["oscale"],
                s["a_q"], s["a_scale"])
            assert tk.COUNTS["plain_calls"] == before + 1
            want = np.asarray(jeng._site_matmul_nobias(jcfg, jx, site))
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        want = np.asarray(jeng._site_matmul_nobias(jcfg, jx, site))
        got = teng._site_matmul_nobias(tcfg, tep, name, tx, l, None)
        assert got.dtype == torch.float32
        if route == "int_mm":
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        s = tep["layers"][name]
        xf = teng.quantize_activation(tx, s["a_grid"][l], s["a_alpha"][l])
        assert xf.dtype == _BF
        if route == "w4pack":
            wv = tq.dequant_w4_reference(s["packed"][l], s["scale"][l],
                                         s["grid"][l])
        else:
            wv = s["w_i8"][l].t().double() * s["oscale"][l].double()
        size = (xf.abs().double() @ wv.abs().double()).numpy()
        err = np.abs(got.numpy().astype(np.float64) - want)
        assert (err <= 2 * K * 2.0 ** -24 * size).all(), (l, err.max())


def _engine_close(tl: np.ndarray, jl: np.ndarray, what: str):
    d = np.abs(tl - jl)
    top = np.abs(jl).max()
    med, big = _ENGINE_TOL
    assert np.median(d) <= med * top and d.max() <= big * top, (
        what, np.median(d), d.max(), top)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1),
                                  err_msg=what)


def _run_engines(jcfg, tcfg, params, quant, ids, steps):
    jep = jeng.build_engine_params(jcfg, params, quant)
    tep = convert.from_jax_engine_params(_np_tree(jep), device="cpu")
    B = ids.shape[0]
    jkv = jeng.init_cache(jcfg, B)
    tkv = teng.init_cache(tcfg, B, device="cpu")
    pos = 0
    for step in range(1 + steps):
        jl, jkv = jeng.forward(jcfg, jep, jnp.asarray(ids), jkv, pos)
        tl, tkv = teng.forward(tcfg, tep, torch.from_numpy(ids), tkv, pos)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32
        _engine_close(tl.numpy(), jl, f"step {step}")
        pos += ids.shape[1]
        ids = jl[:, -1:].argmax(-1)      # both engines take the same token


def _bf16(jcfg, tcfg):
    import dataclasses
    return (dataclasses.replace(jcfg, dtype=jnp.bfloat16),
            dataclasses.replace(tcfg, dtype=_BF))


def test_opt_engine_bf16_matches_reference():
    """The 2-layer OPT W4A4 engine (int8 head): prefill on the ``_int_mm``
    route, then a decode step on K1's plain version."""
    jcfg, tcfg = _bf16(*opt._configs())
    ids = np.random.default_rng(1).integers(0, 128, (opt._B, opt._T))
    _run_engines(jcfg, tcfg, *opt._model(seed=0), ids, steps=1)


def test_bloom_engine_bf16_matches_reference():
    """The 2-layer BLOOM engine (fused qkv, ALiBi, GELU: where F1 showed)
    at bf16."""
    jcfg, tcfg = _bf16(*bloom.configs(64))
    ids = np.random.default_rng(1).integers(0, 128, (bloom._B, 8))
    _run_engines(jcfg, tcfg, *bloom.bloom_model(seed=0), ids, steps=1)
