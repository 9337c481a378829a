"""PyTorch port vs the JAX reference: the image layers and models
(``nn/layers.py``'s ``QuantConv`` and ``QuantMultiHeadAttention``,
``models/resnet.py``, ``cnn.py``, ``vit.py``, ``inception.py``) and their
torchvision importers.

The port keeps torchvision's layout (NCHW activations, OIHW kernels), the
reference the TPU's (NHWC, HWIO); ``convert.from_jax_image_params``
carries the reference's params across and the tests compare by logical
position.

- ``QuantConv`` under ANT (grouped, strided, bias) and OliVe (OVP pairs
  along the input channels), and ``QuantMultiHeadAttention`` with a
  mask: each side calibrates its own layer on the same data (the seed
  first checked clear of near-ties on the reference's scores); the
  weight states bit-equal in every field (OliVe's alphas within 4 x
  2^-23 relative: its 3-sigma base, a mean and a std, within 2 ulps),
  the input states within 1e-5 relative in alpha; outputs within
  QUANT_TOL;
- the models at small inputs (ResNet with BasicBlocks and Bottlenecks at
  32 px, a 2-layer ViT at 32 with 8 px patches; VGG16-BN, AlexNet and
  Inception-v3 in ``tests/test_torch_image_cnn.py`` through this file's
  helpers), on the port's init carried into the reference (its BatchNorm
  statistics and ViT's class token drawn away from their inits):
  unquantized logits within FLOAT_TOL of the largest, and quantized
  logits on the port's own calibration carried into the reference (the
  layer tests hold calibration; these hold the forward: every site, pool
  and concatenation in the same logical order) within QUANT_TOL, the
  sites those of the reference's ``jax.eval_shape`` of its init, in its
  order;
- every torchvision importer: a generated torchvision state dict
  (``chip_smoke.torchvision_state_dict``) through the reference's
  importer and ``from_jax_image_params`` equals it through the port's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ant_quantization_tpu.calibrate import promote as jpr
from ant_quantization_tpu.models import cnn as jcnn
from ant_quantization_tpu.models import inception as jinc
from ant_quantization_tpu.models import resnet as jres
from ant_quantization_tpu.models import vit as jvit
from ant_quantization_tpu.nn import layers as jl
from ant_quantization_tpu.nn.config import QuantConfig as JQ
from ant_quantization_tpu_torch import convert
from ant_quantization_tpu_torch.calibrate import promote as tpr
from ant_quantization_tpu_torch.models import cnn as tcnn
from ant_quantization_tpu_torch.models import inception as tinc
from ant_quantization_tpu_torch.models import resnet as tres
from ant_quantization_tpu_torch.models import vit as tvit
from ant_quantization_tpu_torch.models.import_hf import lm_state_dict
from ant_quantization_tpu_torch.models.resnet import batch_stats_tree
from ant_quantization_tpu_torch.models.transformer_lm import params_tree
from ant_quantization_tpu_torch.nn import layers as tl
from ant_quantization_tpu_torch.nn.config import QuantConfig as TQ
from ant_quantization_tpu_torch.utils.calibration import calibrate_model

import chip_smoke
import test_torch_calibrate as tcal
from test_torch_bert import assert_trees_by_rule, to_jax

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.torchdep

# XLA's and torch's convolution, mean and softmax sum in other orders
FLOAT_TOL = 1e-5
# an ulp apart upstream can move an A4 code
QUANT_TOL = 5e-3
ANT = dict(mode="ant-int-pot-flint")
OLIVE = dict(mode="ant-int-flint", family="olive", w_up=250, a_up=250)
# one ratio per type keeps the port's calibration of whole models short;
# the layer tests hold the full search
FAST = dict(mode="ant-int-pot-flint", w_low=100, w_up=101, a_low=100,
            a_up=101)


def nhwc(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def hwio_to_oihw(k):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(k).transpose(3, 2, 0, 1)))


# ---------------------------------------------------------------------------
# QuantConv and QuantMultiHeadAttention
# ---------------------------------------------------------------------------

CONV_CASES = {
    # name: (qcfg, c_in, features, kernel, strides, padding, groups, bias)
    "ant_grouped_strided": (ANT, 8, 12, (3, 3), 2, 1, 2, True),
    "olive_same": (OLIVE, 8, 6, (3, 3), 1, "SAME", 1, False),
    "ant_asymmetric": (ANT, 6, 8, (1, 3), 2, ((0, 1), (1, 0)), 1, True),
}


@functools.lru_cache(maxsize=None)
def conv_case(name):
    q, c_in, feat, k, s, p, g, bias = CONV_CASES[name]
    jm = jl.QuantConv(feat, k, JQ(**q), strides=s, padding=p,
                      feature_group_count=g, use_bias=bias)
    x = nhwc(3, (2, 9, 9, c_in))
    params = jax.tree_util.tree_map(np.asarray, jl.QuantConv(
        feat, k, JQ(enabled=False), strides=s, padding=p,
        feature_group_count=g, use_bias=bias).init(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    if bias:
        params["bias"] = nhwc(4, (1, 1, 1, feat)).reshape(feat)
    want, upd = jm.apply({"params": params}, jnp.asarray(x),
                         mutable=["quant"])
    tm = tl.QuantConv(c_in, feat, k, TQ(**q), strides=s, padding=p,
                      feature_group_count=g, use_bias=bias, device="cpu")
    with torch.no_grad():
        tm.kernel.copy_(hwio_to_oihw(params["kernel"]))
        if bias:
            tm.bias.copy_(torch.from_numpy(params["bias"]))
    got, tq = calibrate_model(tm, nchw(x))
    return x, params, (np.asarray(want), upd["quant"]), (got.numpy(), tq)


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_quant_conv_against_jax(name):
    q = CONV_CASES[name][0]
    x, params, (want, jq), (got, tq) = conv_case(name)
    wsite = dataclasses.asdict(JQ(**q).weight_site(channel_axis=-1,
                                                   pair_axis=2))
    tcal._assert_clear_of_ties(params["kernel"], wsite)
    tcal._assert_clear_of_ties(x, dataclasses.asdict(JQ(**q).input_site()))
    family = q.get("family", "ant")
    assert_trees_by_rule({"conv": jq}, {"conv": tq}, family)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2),
                               rtol=QUANT_TOL, atol=QUANT_TOL)


def test_quant_conv_padding_forms():
    """"SAME" pads as XLA does (the odd pixel at the end), ints and pairs
    as given."""
    assert tl.conv_padding("SAME", (9, 8), (3, 3), (2, 2)) == (
        (1, 1), (0, 1))
    assert tl.conv_padding("VALID", (9, 8), (3, 3), (1, 1)) == (
        (0, 0), (0, 0))
    assert tl.conv_padding(2, (9, 9), (5, 5), (1, 1)) == ((2, 2), (2, 2))


@functools.lru_cache(maxsize=None)
def mha_case():
    e, heads = 16, 4
    x = nhwc(5, (2, 7, e)).reshape(2, 7, e)
    mask = np.ones((2, 1, 7, 7), bool)
    mask[1, :, :, 5:] = False
    jm = jl.QuantMultiHeadAttention(heads, JQ(**ANT))
    params = jax.tree_util.tree_map(np.asarray, jl.QuantMultiHeadAttention(
        heads, JQ(enabled=False)).init(jax.random.PRNGKey(2),
                                       jnp.asarray(x))["params"])
    want, upd = jm.apply({"params": params}, jnp.asarray(x),
                         jnp.asarray(mask), mutable=["quant"])
    tm = tl.QuantMultiHeadAttention(e, heads, TQ(**ANT), device="cpu")
    tm.load_state_dict(convert.from_jax_lm_params(params, device="cpu"))
    got, tq = calibrate_model(tm, torch.from_numpy(x),
                              torch.from_numpy(mask))
    return x, params, (np.asarray(want), upd["quant"]), (got.numpy(), tq)


def test_quant_multi_head_attention_with_a_mask():
    x, params, (want, jq), (got, tq) = mha_case()
    tcal._assert_clear_of_ties(params["in_proj"]["kernel"],
                               dataclasses.asdict(JQ(**ANT).weight_site()))
    tcal._assert_clear_of_ties(x, dataclasses.asdict(JQ(**ANT).input_site()))
    assert_trees_by_rule(jq, tq, "ant")
    assert [p for p, _ in tpr.quant_sites(tq)] == [("in_proj",),
                                                   ("out_proj",)]
    np.testing.assert_allclose(got, want, rtol=QUANT_TOL, atol=QUANT_TOL)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

SMALL_VIT = dict(image_size=32, patch_size=8, d_model=32, n_layers=2,
                 n_heads=4, d_ff=64, num_classes=10)
MODELS = {
    # name: (reference builder, port builder, image side, BN)
    "resnet_basic": (
        lambda q: jres.ResNet(jres.ResNetConfig("basic", (1, 1, 1, 1), 10),
                              q),
        lambda q: tres.ResNet(tres.ResNetConfig("basic", (1, 1, 1, 1), 10),
                              q, device="cpu"), 32, True),
    "resnet_bottleneck": (
        lambda q: jres.ResNet(jres.ResNetConfig("bottleneck", (1, 1, 1, 1),
                                                10), q),
        lambda q: tres.ResNet(tres.ResNetConfig("bottleneck", (1, 1, 1, 1),
                                                10), q, device="cpu"),
        32, True),
    "vgg16_bn": (
        lambda q: jcnn.VGG16(q, num_classes=10, with_bn=True),
        lambda q: tcnn.VGG16(q, num_classes=10, with_bn=True, image_size=32,
                             device="cpu"), 32, True),
    "alexnet": (
        lambda q: jcnn.AlexNet(q, num_classes=10),
        lambda q: tcnn.AlexNet(q, num_classes=10, image_size=64,
                               device="cpu"), 64, False),
    "vit": (
        lambda q: jvit.ViT(jvit.ViTConfig(**SMALL_VIT), q),
        lambda q: tvit.ViT(tvit.ViTConfig(**SMALL_VIT), q, device="cpu"),
        32, False),
    "inception_v3": (
        lambda q: jinc.InceptionV3(jinc.InceptionConfig(10), q),
        lambda q: tinc.InceptionV3(tinc.InceptionConfig(10), q,
                                   device="cpu"), 75, True),
}


def jax_variables(tm):
    """The port's model as the reference's variables (numpy): params with
    HWIO kernels, batch_stats."""
    def walk(node, hwio):
        return {k: walk(v, hwio) if isinstance(v, dict) else (
            np.ascontiguousarray(v.numpy().transpose(2, 3, 1, 0))
            if hwio and v.ndim == 4 else v.numpy().copy())
            for k, v in node.items()}

    v = {"params": walk(params_tree(tm), True)}
    stats = batch_stats_tree(tm)
    if stats:
        v["batch_stats"] = walk(stats, False)
    return v


@functools.lru_cache(maxsize=None)
def model_case(name):
    """(reference variables, the port's float model, images): the port's
    init, with BatchNorm's affine and running statistics and ViT's class
    token drawn away from their (1, 0) and 0 inits."""
    jb, tb, side, bn = MODELS[name]
    x = nhwc(11, (2, side, side, 3))
    torch.manual_seed(11)          # the port's init draws from torch's
    tm = tb(TQ(enabled=False))
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for key, t in tm.state_dict().items():
            leaf = key.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif leaf in ("mean", "class_token") or (
                    leaf == "bias" and "bn" in key):
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return jax_variables(tm), tm, x


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def float_logits(name):
    v, tm, x = model_case(name)
    jm = MODELS[name][0](JQ(enabled=False))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    assert _rel(got, want) <= FLOAT_TOL


def quantized_logits(name, site_order=True):
    """The port calibrates its model; the reference applies the same
    states to the same weights; with ``site_order`` the sites are the
    reference's, in its order. Returns the port's sites."""
    v, _, x = model_case(name)
    tm = MODELS[name][1](TQ(**FAST))
    tm.load_state_dict(convert.from_jax_image_params(
        v["params"], v.get("batch_stats"), device="cpu"))
    got, tq = calibrate_model(tm, nchw(x))
    jm = MODELS[name][0](JQ(**FAST))
    want = np.asarray(jax.jit(jm.apply)({**v, "quant": to_jax(tq)},
                                        jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=QUANT_TOL,
                               atol=QUANT_TOL * np.abs(want).max())
    sites = tpr.quant_sites(tq)
    assert all(int(st["weight_q"].bit) == 4 for _, st in sites)
    if site_order:
        assert reference_sites(name, x) == [p for p, _ in sites]
    return sites


def reference_sites(name, x):
    """The reference's quantized sites in its order: the modules holding
    a ``kernel`` in ``jax.eval_shape`` of its unquantized init (a
    quantized init traces every site's calibration), by the natural
    path sort of its ``quant_sites``."""
    params = jax.eval_shape(MODELS[name][0](JQ(enabled=False)).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    paths = []

    def walk(node, path):
        if "kernel" in node:
            paths.append(path)
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))

    walk(params, ())
    return sorted(paths, key=jpr._natural_key)


# the larger models are held in tests/test_torch_image_cnn.py
SMALL = ("resnet_basic", "resnet_bottleneck", "vit")


@pytest.mark.parametrize("name", SMALL)
def test_float_logits_against_jax(name):
    float_logits(name)


@pytest.mark.parametrize("name", SMALL)
def test_quantized_logits_on_the_same_states(name):
    quantized_logits(name)


# ---------------------------------------------------------------------------
# torchvision importers
# ---------------------------------------------------------------------------

IMPORTERS = {
    # name: (port model, reference importer, port importer)
    "resnet18": (lambda: tres.ResNet(tres.resnet18_config(), TQ(
        enabled=False), device="cpu"),
        lambda sd: jres.import_torchvision_resnet(sd, jres.resnet18_config()),
        lambda sd: tres.import_torchvision_resnet(sd, tres.resnet18_config())),
    "resnet50": (lambda: tres.ResNet(tres.resnet50_config(), TQ(
        enabled=False), device="cpu"),
        lambda sd: jres.import_torchvision_resnet(sd, jres.resnet50_config()),
        lambda sd: tres.import_torchvision_resnet(sd, tres.resnet50_config())),
    "vgg16_bn": (lambda: tcnn.VGG16(TQ(enabled=False), 10, True, 32, "cpu"),
                 lambda sd: jcnn.import_torchvision_vgg16(sd, True),
                 lambda sd: tcnn.import_torchvision_vgg16(sd, True)),
    "vgg16": (lambda: tcnn.VGG16(TQ(enabled=False), 10, False, 32, "cpu"),
              lambda sd: (jcnn.import_torchvision_vgg16(sd), None),
              lambda sd: (tcnn.import_torchvision_vgg16(sd), None)),
    "alexnet": (lambda: tcnn.AlexNet(TQ(enabled=False), 10, 64, "cpu"),
                lambda sd: (jcnn.import_torchvision_alexnet(sd), None),
                lambda sd: (tcnn.import_torchvision_alexnet(sd), None)),
    "vit_b_16": (lambda: tvit.ViT(tvit.ViTConfig(**SMALL_VIT), TQ(
        enabled=False), device="cpu"),
        lambda sd: (jvit.import_torchvision_vit(
            sd, jvit.ViTConfig(**SMALL_VIT)), None),
        lambda sd: (tvit.import_torchvision_vit(
            sd, tvit.ViTConfig(**SMALL_VIT)), None)),
    "inception_v3": (lambda: tinc.InceptionV3(tinc.InceptionConfig(10), TQ(
        enabled=False), device="cpu"),
        lambda sd: jinc.import_torchvision_inception(
            sd, jinc.InceptionConfig(10)),
        lambda sd: tinc.import_torchvision_inception(
            sd, tinc.InceptionConfig(10))),
}


@pytest.mark.parametrize("name", sorted(IMPORTERS))
def test_torchvision_importers_against_jax(name):
    build, jimp, timp = IMPORTERS[name]
    model = build()
    sd = chip_smoke.image_checkpoint(torch, name, 0, "cpu", model=model)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    jp, jst = jimp(np_sd)
    want = convert.from_jax_image_params(jp, jst, device="cpu")
    tp, tst = timp(sd)
    got = lm_state_dict(tp)
    got.update(lm_state_dict(tst or {}))
    assert set(got) == set(want) == set(model.state_dict())
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy(),
                                      err_msg=k)
    model.load_state_dict(got)
