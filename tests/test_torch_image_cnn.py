"""PyTorch port vs the JAX reference: VGG16-BN (32 px), AlexNet (64 px)
and Inception-v3 (75 px, the smallest input its strides allow), by the
rules of ``tests/test_torch_image_models.py`` (which holds the layers,
the ResNets, the ViT and the importers): unquantized logits within
FLOAT_TOL of the largest, quantized logits on the port's calibration
carried into the reference within QUANT_TOL; for Inception-v3 the
sites the reference's (its ``jax.eval_shape``) in its order, 95 of
them, 94 convolutions and the fc, the indices of the recipes'
``layers8 "0,1,2,3,94"``.
"""

import pytest

from test_torch_engine import one_torch_thread  # noqa: F401 (autouse)
from test_torch_image_models import float_logits, quantized_logits

pytestmark = pytest.mark.torchdep


@pytest.mark.parametrize("name", ("vgg16_bn", "alexnet", "inception_v3"))
def test_float_logits_against_jax(name):
    float_logits(name)


@pytest.mark.parametrize("name", ("vgg16_bn", "alexnet"))
def test_quantized_logits_on_the_same_states(name):
    quantized_logits(name, site_order=False)


def test_inception_quantized_logits_and_its_95_sites():
    sites = quantized_logits("inception_v3")
    assert len(sites) == 95
    assert sites[0][0] == ("Conv2d_1a_3x3", "conv")
    assert sites[94][0] == ("fc",)
    assert sum(p[-1] == "conv" for p, _ in sites) == 94
