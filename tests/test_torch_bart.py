"""PyTorch port vs the JAX reference: BART (``models/bart.py``) with its
GLUE and SQuAD heads, on a model of one encoder and one decoder layer,
d_model 32 (4 heads of 8), d_ff 32 (64 in the HF import), vocab 128, on
rows with two eos tokens, one, and none (pooled at position 0), padded by
the attention mask:

- the float model, the reference's params carried across
  (``convert.from_jax_lm_params``), within 1e-5 of the reference's logits
  (both heads); its encoder and decoder states too, with the default
  shifted decoder input and with an explicit one;
- cross-attention (``BartAttention`` with ``kv``) at 5 queries over 9
  keys under a padded encoder mask, within 1e-5 of the reference's;
- the calibrated fake-quant model under ANT (both heads; OliVe in
  ``tests/test_torch_bart_olive.py``, whose reference calibration alone
  takes half a minute) against the reference's calibration on the same
  batch, by ``test_torch_bert``'s tree rule, the seed first checked clear
  of near-ties at the first site, then the calibrating forwards' outputs
  within 5e-3;
- ``--n8`` and ``--layers8`` promotion picks the same sites.

``import_hf_bart`` is held in ``tests/test_torch_encoder_hf.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate import promote as jpr
from ant_quantization_tpu.models import bart as jba
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu.utils import calibration as jcal
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.calibrate import promote as tpr
from ant_quantization_tpu_torch.models import bart as tba
from ant_quantization_tpu_torch.models.bert import additive_mask
from ant_quantization_tpu_torch.nn import layers as tl
from ant_quantization_tpu_torch.nn.config import QuantConfig as TQ
from ant_quantization_tpu_torch.utils.calibration import (
    calibrate_model as tcal_model)

import test_torch_calibrate as tcal
from test_torch_bert import (FAMILIES, FLOAT_ATOL, QUANT_TOL,
                             assert_trees_by_rule, outputs, port_model,
                             promote_and_recalibrate, run_both)

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

GEOM = dict(vocab_size=128, d_model=32, enc_layers=1, dec_layers=1,
            n_heads=4, d_ff=32, max_seq=64, num_labels=3)
G = tuple(GEOM.items())
HEADS = {"cls": (jba.BartForSequenceClassification,
                 tba.BartForSequenceClassification),
         "qa": (jba.BartForQuestionAnswering, tba.BartForQuestionAnswering)}
EOS = 2


def batch(seed, B=3, T=12):
    """ids without eos, then row 0 with two eos, row 1 with one at its
    last unpadded position, row 2 (if any) with none; the mask pads row 1
    by 4 positions and row 2 by 7."""
    ids = np.random.default_rng(seed).integers(3, GEOM["vocab_size"],
                                               (B, T))
    ids[0, 3] = ids[0, T - 2] = EOS
    ids[1, T - 5] = EOS
    am = np.ones_like(ids)
    am[1, -4:] = 0
    am[2:, -7:] = 0
    return ids, None, am


@functools.lru_cache(maxsize=None)
def jax_params(jcls, geom_items, seed=0):
    m = jcls(jba.BartConfig(**dict(geom_items)), JQ(enabled=False))
    return jax.tree_util.tree_map(np.asarray, jax.jit(m.init)(
        jax.random.PRNGKey(seed), jnp.asarray(batch(0)[0]))["params"])


@pytest.mark.parametrize("head", sorted(HEADS))
def test_float_logits_from_the_jax_params(head):
    jcls, tcls = HEADS[head]
    params = jax_params(jcls, G)
    jm = jcls(jba.BartConfig(**GEOM), JQ(enabled=False))
    tm = port_model(tcls, tba.BartConfig(**GEOM), dict(enabled=False),
                    params)
    assert tl.quant_tree(tm) == {}
    want, got = run_both(jm, {"params": params}, tm, batch(1))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_ATOL)


def test_pooling_at_the_last_eos_or_position_0():
    """The classification head reads the decoder state at each row's last
    eos, and at position 0 in the row without one."""
    params = jax_params(HEADS["cls"][0], G)
    tm = port_model(HEADS["cls"][1], tba.BartConfig(**GEOM),
                    dict(enabled=False), params)
    ids, _, am = batch(1)
    with torch.no_grad():
        dec, _ = tm.model(torch.from_numpy(ids), torch.from_numpy(am))
        pooled = dec[torch.arange(3), torch.tensor([10, 7, 0])]
        want = tm.classification_head(pooled)
        got = tm(torch.from_numpy(ids), None, torch.from_numpy(am))
    assert torch.equal(got, want)


@pytest.mark.parametrize("explicit_decoder_ids", [False, True])
def test_encoder_and_decoder_states(explicit_decoder_ids):
    params = jax_params(HEADS["cls"][0], G)
    jm = jba.BartModel(jba.BartConfig(**GEOM), JQ(enabled=False))
    tm = tba.BartModel(tba.BartConfig(**GEOM), TQ(enabled=False),
                       device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(params["model"],
                                                  device="cpu"))
    ids, _, am = batch(2)
    dec_ids = (np.random.default_rng(3).integers(0, 128, (3, 7))
               if explicit_decoder_ids else None)
    want, got = run_both(jm, {"params": params["model"]}, tm,
                         (ids, am, dec_ids))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=FLOAT_ATOL)


def test_cross_attention_under_a_padded_encoder_mask():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    enc = rng.normal(size=(2, 9, 32)).astype(np.float32)
    am = np.ones((2, 9), np.int32)
    am[1, 4:] = 0
    jm = jba.BartAttention(jba.BartConfig(**GEOM), JQ(enabled=False))
    p = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(x), kv=jnp.asarray(enc))[
            "params"])
    jmask = jba._additive_mask(jnp.asarray(am))
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x),
                               kv=jnp.asarray(enc), mask=jmask))
    tm = tba.BartAttention(tba.BartConfig(**GEOM), TQ(enabled=False),
                           device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(p, device="cpu"))
    tmask = additive_mask(torch.from_numpy(am))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), kv=torch.from_numpy(enc), mask=tmask)
        # a padded key changes nothing
        enc2 = enc.copy()
        enc2[1, 4:] += 3.0
        moved = tm(torch.from_numpy(x), kv=torch.from_numpy(enc2),
                   mask=tmask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_ATOL)
    assert torch.equal(moved[1], got[1])


def calib_batch():
    ids, _, am = batch(10, B=2, T=16)
    return ids, np.zeros_like(ids), am


@functools.lru_cache(maxsize=None)
def calibrated(head, family):
    """As ``test_torch_bert.calibrated``, for BART."""
    jcls, tcls = HEADS[head]
    params = jax_params(jcls, G)
    qkw = FAMILIES[family]
    jm = jcls(jba.BartConfig(**GEOM), JQ(**qkw))
    tm = port_model(tcls, tba.BartConfig(**GEOM), qkw, params)
    b = calib_batch()
    jout, jq = jcal.calibrate_model(jm, {"params": params},
                                    *(jnp.asarray(a) for a in b))
    tout, tq = tcal_model(tm, *(torch.from_numpy(a) for a in b))
    return jm, params, jq, tm, tq, (jout, tout)


@pytest.mark.parametrize("head,family", [("cls", "ant"), ("qa", "ant")])
def test_calibrated_fake_quant_against_jax(head, family):
    check_calibrated(head, family)


def check_calibrated(head, family):
    """Calibration by the tree rule (the seed first checked clear of
    near-ties at the first site, weight and input; the decoder's
    cross-attention sites present), then the calibrating forwards'
    outputs, each on its own new states, within QUANT_TOL."""
    _, params, jq, _, tq, (jout, tout) = calibrated(head, family)
    jqcfg = JQ(**FAMILIES[family])
    if head == "cls":
        tcal._assert_clear_of_ties(
            params["model"]["enc_0"]["self_attn"]["q_proj"]["kernel"],
            dataclasses.asdict(jqcfg.weight_site()))
        tm = port_model(HEADS["cls"][1], tba.BartConfig(**GEOM),
                        dict(enabled=False), params)
        xs = []
        h = tm.model.enc_0.self_attn.q_proj.register_forward_pre_hook(
            lambda m, a: xs.append(a[0].detach().numpy()) and None)
        with torch.no_grad():
            tm(*(torch.from_numpy(a) for a in calib_batch()))
        h.remove()
        tcal._assert_clear_of_ties(xs[0],
                                   dataclasses.asdict(jqcfg.input_site()))
    assert_trees_by_rule(jq, tq, family)
    paths = [p for p, _ in tpr.quant_sites(tq)]
    dec = [p[-1] for p in paths if p[:3] == ("model", "dec_0",
                                             "encoder_attn")]
    assert dec == ["k_proj", "out_proj", "q_proj", "v_proj"]
    assert {p[0] for p in paths} == (
        {"model", "qa_outputs"} if head == "qa"
        else {"model", "classification_head"})
    for w, g in zip(outputs(jout), outputs(tout)):
        np.testing.assert_allclose(g, w, rtol=QUANT_TOL, atol=QUANT_TOL)


@pytest.mark.parametrize("promote", [dict(n8=3), dict(layer_list="0,7")])
def test_promotion_picks_the_same_sites(promote):
    jm, params, jq, tm, tq, _ = calibrated("cls", "ant")
    jq, tq = promote_and_recalibrate(jm, params, jq, tm, tq, calib_batch(),
                                     promote)
    assert_trees_by_rule(jq, tq, "ant")
    promoted = tpr.promoted_site_paths(tq)
    assert promoted == jpr.promoted_site_paths(jq)
    assert len(promoted) == (3 if "n8" in promote else 2)
