"""PyTorch port vs the JAX reference: BERT (``models/bert.py``) with its
GLUE and SQuAD heads, on 2-layer models of d_model 32 (4 heads of 8,
d_ff 32, vocab 128; d_ff 64 in the HF import), rows padded by the
attention mask, two token types:

- the float model, the reference's params carried across
  (``convert.from_jax_lm_params``), within 1e-5 of the reference's logits
  (both heads; XLA's and torch's erfc, exp and sum orders differ by
  ulps);
- the calibrated fake-quant model under ANT ("ant-int-pot-flint") and
  OliVe ("ant-int-flint", OVP): the port's calibration of its model
  against the reference's of its on the same batch, by the tree rule (the
  same site paths in the same order; every weight state of the same type,
  bit and signedness, ANT's alphas bit-equal and OliVe's within 4 x
  2^-23 relative (its 3-sigma base, a mean and a std, within 2 ulps,
  times the ratio); input alphas within 1e-5
  relative), the seed first checked clear of near-ties on the reference's
  scores at the first sites; then the logits on the port's states within
  5e-3 (an ulp apart upstream can move an A4 code);
- ``--n8`` and ``--layers8`` promotion picks the same sites (promotion
  of each side's first-pass tree, then one calibrating pass, as
  ``calibrate_on_batches`` does).

``import_hf_bert`` is held in ``tests/test_torch_encoder_hf.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate import promote as jpr
from ant_quantization_tpu.calibrate import spec as jsp
from ant_quantization_tpu.models import bert as jb
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu.utils import calibration as jcal
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.calibrate import promote as tpr
from ant_quantization_tpu_torch.calibrate import spec as tsp
from ant_quantization_tpu_torch.models import bert as tb
from ant_quantization_tpu_torch.nn import layers as tl
from ant_quantization_tpu_torch.nn.config import QuantConfig as TQ
from ant_quantization_tpu_torch.utils.calibration import (
    calibrate_model as tcal_model)

import test_torch_calibrate as tcal

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

FLOAT_ATOL = 1e-5
QUANT_TOL = 5e-3
HF_TOL = dict(rtol=2e-4, atol=2e-4)
# OliVe's weight base (3 sigma: a mean and a std) agrees within 2 ulps,
# so alpha = base x ratio within 4 x 2^-23 relative
OLIVE_W_RTOL = 4 * 2.0 ** -23
ANT = dict(mode="ant-int-pot-flint")
OLIVE = dict(mode="ant-int-flint", family="olive", w_up=250, a_up=250)
FAMILIES = {"ant": ANT, "olive": OLIVE}

# d_ff = d_model keeps the reference's calibration programs (one per
# tensor shape and site config) few; the HF import holds d_ff 64
GEOM = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=32,
            max_seq=64, num_labels=3)
HEADS = {"cls": (jb.BertForSequenceClassification,
                 tb.BertForSequenceClassification),
         "qa": (jb.BertForQuestionAnswering, tb.BertForQuestionAnswering)}


def batch(seed, B=3, T=12):
    """ids, token types (second segment from T/2) and a mask that pads
    row 1 by 4 positions and row 2 (if any) by 7."""
    ids = np.random.default_rng(seed).integers(0, GEOM["vocab_size"],
                                               (B, T))
    tt = np.zeros_like(ids)
    tt[:, T // 2:] = 1
    am = np.ones_like(ids)
    am[1, -4:] = 0
    am[2:, -7:] = 0
    return ids, tt, am


def np_tree(tree):
    """Leaves of a nested dict (tensors and QuantStates) -> numpy."""
    if isinstance(tree, tsp.QuantState):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def to_jax(tree):
    """The port's quant tree -> the reference's (its QuantState)."""
    if isinstance(tree, tsp.QuantState):
        return jsp.QuantState(**{k: jnp.asarray(v)
                                 for k, v in tree.numpy().items()})
    return {k: to_jax(v) for k, v in tree.items()}


def assert_trees_by_rule(jtree, ttree, family):
    """The same site paths in the same order; per state the same type,
    bit, signedness, grid, outliers and flag; weight alphas bit-equal
    (ANT) or within OLIVE_W_RTOL (OliVe), input alphas within 1e-5
    relative."""
    js, ts = jpr.quant_sites(jtree), tpr.quant_sites(ttree)
    assert [p for p, _ in js] == [p for p, _ in ts]
    for (path, j), (_, t) in zip(js, ts):
        for k in ("weight_q", "input_q"):
            a, b = j[k], t[k]
            for f in ("grid", "outliers", "bit", "mode_idx", "is_signed",
                      "initialized"):
                np.testing.assert_array_equal(
                    getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                    err_msg=f"{path} {k} {f}")
            rtol = (1e-5 if k == "input_q" else
                    0 if family == "ant" else OLIVE_W_RTOL)
            np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha),
                                       rtol=rtol,
                                       err_msg=f"{path} {k} alpha")


@functools.lru_cache(maxsize=None)
def jax_params(jcls, geom_items, seed=0):
    """The reference model's params from an unquantized init (a quantized
    flax init would calibrate), as numpy."""
    m = jcls(_jcfg(jcls, geom_items), JQ(enabled=False))
    ids = jnp.asarray(batch(0)[0])
    return jax.tree_util.tree_map(np.asarray, jax.jit(m.init)(
        jax.random.PRNGKey(seed), ids)["params"])


def _jcfg(jcls, geom_items):
    from ant_quantization_tpu.models import bart as jba
    cfg_cls = (jba.BartConfig if jcls.__module__ == jba.__name__
               else jb.BertConfig)
    return cfg_cls(**dict(geom_items))


def port_model(tcls, tcfg, qkw, params):
    m = tcls(tcfg, TQ(**qkw), device="cpu")
    m.load_state_dict(convert.from_jax_lm_params(params, device="cpu"))
    return m


def run_both(jm, variables, tm, args):
    """The reference's and the port's outputs (a tuple of arrays for the
    QA head) on the same numpy forward arguments."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    want = jax.jit(jm.apply)(variables, *jargs)
    with torch.no_grad():
        got = tm(*targs)
    if isinstance(want, tuple):
        return ([np.asarray(w) for w in want],
                [g.numpy() for g in got])
    return [np.asarray(want)], [got.numpy()]


G = tuple(GEOM.items())


@pytest.mark.parametrize("head", sorted(HEADS))
def test_float_logits_from_the_jax_params(head):
    """The reference's params carried across: the port's float model
    gives its logits within FLOAT_ATOL, padded rows included."""
    jcls, tcls = HEADS[head]
    params = jax_params(jcls, G)
    jm = jcls(jb.BertConfig(**GEOM), JQ(enabled=False))
    tm = port_model(tcls, tb.BertConfig(**GEOM), dict(enabled=False),
                    params)
    assert tl.quant_tree(tm) == {}
    want, got = run_both(jm, {"params": params}, tm, batch(1))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_ATOL)


def calib_batch():
    return batch(10, B=2, T=16)


@functools.lru_cache(maxsize=None)
def calibrated(head, family):
    """(reference model, params, reference quant tree, port model, port
    quant tree, (reference output, port output)) after one calibration
    forward of each on the same batch (each output on its own new
    states)."""
    jcls, tcls = HEADS[head]
    params = jax_params(jcls, G)
    qkw = FAMILIES[family]
    jm = jcls(jb.BertConfig(**GEOM), JQ(**qkw))
    tm = port_model(tcls, tb.BertConfig(**GEOM), qkw, params)
    b = calib_batch()
    jout, jq = jcal.calibrate_model(jm, {"params": params},
                                    *(jnp.asarray(a) for a in b))
    tout, tq = tcal_model(tm, *(torch.from_numpy(a) for a in b))
    return jm, params, jq, tm, tq, (jout, tout)


def promote_and_recalibrate(jm, params, jq, tm, tq, b, promote):
    """Promotion of each side's first-pass tree (``n8`` or
    ``layer_list``), then one calibrating pass of each on the numpy batch
    ``b``, as ``calibrate_on_batches`` does after its first pass."""
    if "n8" in promote:
        fns, arg = (jpr.set_8_bit_layer_n, tpr.set_8_bit_layer_n), \
            promote["n8"]
    else:
        fns, arg = (jpr.set_8_bit_layer_l, tpr.set_8_bit_layer_l), \
            promote["layer_list"]
    _, jq8 = jcal.calibrate_model(
        jm, {"params": params, "quant": fns[0](jq, arg)},
        *(jnp.asarray(a) for a in b))
    _, tq8 = tcal_model(tm, *(torch.from_numpy(a) for a in b),
                        quant=fns[1](tq, arg))
    return jq8, tq8


def first_site_inputs(tm):
    """The calibration input of the first site (the first layer's query)
    in the port's float model."""
    xs = {}

    def keep(name):
        def hook(m, args):
            xs.setdefault(name.split(".")[-1], args[0].detach().numpy())
        return hook

    hooks = [m.register_forward_pre_hook(keep(n))
             for n, m in tm.named_modules()
             if n.endswith("layer_0.attention.query")]
    with torch.no_grad():
        tm(*(torch.from_numpy(a) for a in calib_batch()))
    for h in hooks:
        h.remove()
    return xs


def outputs(out):
    return [np.asarray(o.detach()) if isinstance(o, torch.Tensor)
            else np.asarray(o)
            for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("head,family", [("cls", "ant"), ("cls", "olive"),
                                         ("qa", "ant")])
def test_calibrated_fake_quant_against_jax(head, family):
    """Calibration by the tree rule (the seed first checked clear of
    near-ties at the first site, weight and input), then the calibrating
    forwards' outputs, each on its own new states, within QUANT_TOL."""
    jm, params, jq, tm, tq, (jout, tout) = calibrated(head, family)
    jqcfg = JQ(**FAMILIES[family])
    if head == "cls":
        xs = first_site_inputs(port_model(
            HEADS["cls"][1], tb.BertConfig(**GEOM), dict(enabled=False),
            params))
        tcal._assert_clear_of_ties(
            params["bert"]["layer_0"]["attention"]["query"]["kernel"],
            dataclasses.asdict(jqcfg.weight_site()))
        tcal._assert_clear_of_ties(xs["query"],
                                   dataclasses.asdict(jqcfg.input_site()))
    assert_trees_by_rule(jq, tq, family)
    assert {p[0] for p, _ in tpr.quant_sites(tq)} == (
        {"bert", "qa_outputs"} if head == "qa"
        else {"bert", "pooler", "classifier"})
    for w, g in zip(outputs(jout), outputs(tout)):
        np.testing.assert_allclose(g, w, rtol=QUANT_TOL, atol=QUANT_TOL)


@pytest.mark.parametrize("promote", [dict(n8=3), dict(layer_list="0,5")])
def test_promotion_picks_the_same_sites(promote):
    jm, params, jq, tm, tq, _ = calibrated("cls", "ant")
    jq, tq = promote_and_recalibrate(jm, params, jq, tm, tq, calib_batch(),
                                     promote)
    assert_trees_by_rule(jq, tq, "ant")
    promoted = tpr.promoted_site_paths(tq)
    assert promoted == jpr.promoted_site_paths(jq)
    assert len(promoted) == (3 if "n8" in promote else 2)
    if "n8" in promote:       # the last two sites are always promoted
        assert promoted[-2:] == [("classifier",), ("pooler", "dense")]
