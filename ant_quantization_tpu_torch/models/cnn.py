"""Quantized AlexNet and VGG16 (torchvision's architectures).

Counterpart of the reference's ``models/cnn.py``: ``QuantConv`` (with
bias) at every convolution, ``QuantDense`` at the three classifier
layers, modules under the reference's names (``conv_{i}``, ``bn_{i}``,
``fc0``-``fc2``). Activations are NCHW, so the flatten before ``fc0`` is
torchvision's order without the reference's transpose. VGG16-BN's
``BatchNorm`` has flax's defaults (momentum 0.99, eps 1e-5), as the
reference's has. AlexNet has no adaptive pool, as the reference's (at
224 px the map is 6 x 6 already).
"""

from __future__ import annotations

from typing import Mapping

from torch import nn
from torch.nn import functional as F

from .._ext import resolve_device
from ..kernels.qmatmul import tf32_off
from ..nn.config import QuantConfig
from ..nn.layers import QuantConv, QuantDense
from .resnet import BatchNorm

__all__ = ["VGG16_LAYOUT", "VGG16", "AlexNet", "import_torchvision_vgg16",
           "import_torchvision_alexnet"]

# torchvision vgg16 "D" configuration: conv widths with 'M' maxpools
VGG16_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M")


def _classifier(mod: nn.Module, n_in: int, qcfg, num_classes, dev):
    mod.fc0 = QuantDense(n_in, 4096, qcfg, device=dev)
    mod.fc1 = QuantDense(4096, 4096, qcfg, device=dev)
    mod.fc2 = QuantDense(4096, num_classes, qcfg, device=dev)


def _classify(mod: nn.Module, x):
    x = x.reshape(x.shape[0], -1)
    x = F.relu(mod.fc0(x))
    x = F.relu(mod.fc1(x))
    return mod.fc2(x)


class VGG16(nn.Module):
    """torchvision VGG-16 ("D"); ``with_bn`` adds BatchNorm after every
    convolution (torchvision ``vgg16_bn``). (B, 3, image_size,
    image_size) -> logits, on ``device`` (default "cuda"); ``image_size``
    sizes ``fc0``, whose input the reference's flax layer takes from the
    first batch."""

    def __init__(self, qcfg: QuantConfig, num_classes: int = 1000,
                 with_bn: bool = False, image_size: int = 224, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.with_bn = with_bn
        c_in, i = 3, 0
        for item in VGG16_LAYOUT:
            if item == "M":
                continue
            self.add_module(f"conv_{i}", QuantConv(c_in, item, (3, 3), qcfg,
                                                   padding=1, device=dev))
            if with_bn:
                self.add_module(f"bn_{i}", BatchNorm(item, device=dev))
            c_in, i = item, i + 1
        side = image_size // 32
        _classifier(self, 512 * side * side, qcfg, num_classes, dev)

    def forward(self, x, train: bool = False):
        with tf32_off():
            i = 0
            for item in VGG16_LAYOUT:
                if item == "M":
                    x = F.max_pool2d(x, 2, 2)
                    continue
                x = getattr(self, f"conv_{i}")(x)
                if self.with_bn:
                    x = getattr(self, f"bn_{i}")(x, train)
                x = F.relu(x)
                i += 1
            return _classify(self, x)


class AlexNet(nn.Module):
    """torchvision AlexNet: (B, 3, image_size, image_size) -> logits, on
    ``device`` (default "cuda"); ``image_size`` sizes ``fc0``."""

    def __init__(self, qcfg: QuantConfig, num_classes: int = 1000,
                 image_size: int = 224, device=None):
        super().__init__()
        dev = resolve_device(device)
        q = qcfg
        self.conv_0 = QuantConv(3, 64, (11, 11), q, strides=4, padding=2,
                                device=dev)
        self.conv_1 = QuantConv(64, 192, (5, 5), q, padding=2, device=dev)
        self.conv_2 = QuantConv(192, 384, (3, 3), q, padding=1, device=dev)
        self.conv_3 = QuantConv(384, 256, (3, 3), q, padding=1, device=dev)
        self.conv_4 = QuantConv(256, 256, (3, 3), q, padding=1, device=dev)
        side = (image_size + 4 - 11) // 4 + 1       # conv_0
        for _ in range(3):                          # the three pools
            side = (side - 3) // 2 + 1
        _classifier(self, 256 * side * side, q, num_classes, dev)

    def forward(self, x, train: bool = False):
        with tf32_off():
            x = F.max_pool2d(F.relu(self.conv_0(x)), 3, 2)
            x = F.max_pool2d(F.relu(self.conv_1(x)), 3, 2)
            x = F.relu(self.conv_2(x))
            x = F.relu(self.conv_3(x))
            x = F.max_pool2d(F.relu(self.conv_4(x)), 3, 2)
            return _classify(self, x)


def _conv(sd, key):
    return {"kernel": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _lin(sd, key):
    return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}


def _vgg_feature_indices(with_bn: bool = False):
    """torchvision vgg16(.features) indices of the convolutions: each is
    followed by ReLU (and BatchNorm in vgg16_bn); pools take a slot."""
    idx, i = [], 0
    per_conv = 3 if with_bn else 2
    for item in VGG16_LAYOUT:
        if item == "M":
            i += 1
        else:
            idx.append(i)
            i += per_conv
    return idx


def import_torchvision_vgg16(sd: Mapping, with_bn: bool = False):
    """vgg16 -> params; vgg16_bn -> (params, batch_stats); the port's
    layout (OIHW kernels, linear kernels (in, out))."""
    params, stats = {}, {}
    for my_i, tv_i in enumerate(_vgg_feature_indices(with_bn)):
        params[f"conv_{my_i}"] = _conv(sd, f"features.{tv_i}")
        if with_bn:
            key = f"features.{tv_i + 1}"
            params[f"bn_{my_i}"] = {"scale": sd[f"{key}.weight"],
                                    "bias": sd[f"{key}.bias"]}
            stats[f"bn_{my_i}"] = {"mean": sd[f"{key}.running_mean"],
                                   "var": sd[f"{key}.running_var"]}
    for my_i, tv_i in enumerate((0, 3, 6)):
        params[f"fc{my_i}"] = _lin(sd, f"classifier.{tv_i}")
    if with_bn:
        return params, stats
    return params


def import_torchvision_alexnet(sd: Mapping):
    params = {}
    for my_i, tv_i in enumerate((0, 3, 6, 8, 10)):
        params[f"conv_{my_i}"] = _conv(sd, f"features.{tv_i}")
    for my_i, tv_i in enumerate((1, 4, 6)):
        params[f"fc{my_i}"] = _lin(sd, f"classifier.{tv_i}")
    return params
