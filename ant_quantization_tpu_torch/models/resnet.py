"""Quantized ResNet family (torchvision's architecture: ResNet-18/34/50/
101/152) and the flax-exact ``BatchNorm`` that every image model with
batch statistics shares.

Counterpart of the reference's ``models/resnet.py``: a ``QuantConv`` or
``QuantDense`` at every convolution and linear site (the reference's
module swap), BatchNorm in full precision. Modules carry the reference's
flax names (``layer1_0.conv1``, ``downsample_conv``, ``fc``), so the
quant tree's paths are the reference's; the layout is torchvision's
(NCHW activations, OIHW kernels), so the torchvision importer copies the
convolutions as they are. Every forward takes ``train``: True normalizes
by the batch's statistics and updates the running ones (flax's
``use_running_average=not train``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .._ext import resolve_device
from ..kernels.qmatmul import tf32_off
from ..nn.config import QuantConfig
from ..nn.layers import QuantConv, QuantDense

__all__ = ["BatchNorm", "batch_stats_tree", "ResNetConfig",
           "resnet18_config", "resnet34_config", "resnet50_config",
           "resnet101_config", "resnet152_config", "BasicBlock",
           "Bottleneck", "ResNet", "import_torchvision_resnet"]


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of NCHW ``x``: parameters
    ``scale`` and ``bias``, running statistics ``mean`` and ``var``
    (buffers; the reference's ``batch_stats``).

    With ``train`` the batch's f32 statistics normalize: the mean and
    E[x^2] - mean^2 clipped at 0 (flax's fast variance), both
    differentiable; the running ones become ``momentum * running + (1 -
    momentum) * batch``, the biased variance included
    (``torch.nn.BatchNorm2d`` keeps the unbiased one). Then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. flax's defaults
    are momentum 0.99 and eps 1e-5."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones((features,), device=device))
        self.bias = nn.Parameter(torch.zeros((features,), device=device))
        self.register_buffer("mean", torch.zeros((features,), device=device))
        self.register_buffer("var", torch.ones((features,), device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.to(torch.float32)
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]


def batch_stats_tree(model: nn.Module) -> Dict:
    """The running statistics of every ``BatchNorm`` of ``model`` as the
    reference's ``batch_stats`` collection: ``{path: {"mean", "var"}}``
    (the tensors themselves, not copies)."""
    tree: Dict = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            node = tree
            for part in name.split("."):
                node = node.setdefault(part, {})
            node["mean"], node["var"] = m.mean, m.var
    return tree


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block: str                 # "basic" | "bottleneck"
    layers: Tuple[int, ...]    # blocks per stage
    num_classes: int = 1000


def resnet18_config():
    return ResNetConfig("basic", (2, 2, 2, 2))


def resnet34_config():
    return ResNetConfig("basic", (3, 4, 6, 3))


def resnet50_config():
    return ResNetConfig("bottleneck", (3, 4, 6, 3))


def resnet101_config():
    return ResNetConfig("bottleneck", (3, 4, 23, 3))


def resnet152_config():
    return ResNetConfig("bottleneck", (3, 8, 36, 3))


def _bn(features: int, device) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, eps=1e-5, device=device)


def _conv(c_in, c_out, k, qcfg, device, strides=1, padding=0):
    return QuantConv(c_in, c_out, (k, k), qcfg, strides=strides,
                     padding=padding, use_bias=False, device=device)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, features: int, qcfg: QuantConfig,
                 strides: int = 1, downsample: bool = False, device=None):
        super().__init__()
        self.conv1 = _conv(c_in, features, 3, qcfg, device, strides, 1)
        self.bn1 = _bn(features, device)
        self.conv2 = _conv(features, features, 3, qcfg, device, 1, 1)
        self.bn2 = _bn(features, device)
        if downsample:
            self.downsample_conv = _conv(c_in, features, 1, qcfg, device,
                                         strides)
            self.downsample_bn = _bn(features, device)

    def forward(self, x, train: bool = False):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, c_in: int, features: int, qcfg: QuantConfig,
                 strides: int = 1, downsample: bool = False, device=None):
        super().__init__()
        self.conv1 = _conv(c_in, features, 1, qcfg, device)
        self.bn1 = _bn(features, device)
        self.conv2 = _conv(features, features, 3, qcfg, device, strides, 1)
        self.bn2 = _bn(features, device)
        self.conv3 = _conv(features, 4 * features, 1, qcfg, device)
        self.bn3 = _bn(4 * features, device)
        if downsample:
            self.downsample_conv = _conv(c_in, 4 * features, 1, qcfg,
                                         device, strides)
            self.downsample_bn = _bn(4 * features, device)

    def forward(self, x, train: bool = False):
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """(B, 3, H, W) images -> (B, num_classes) logits, on ``device``
    (default "cuda"). Weights start as the port's init (convolutions and
    linears normal with std 1/sqrt(fan in), BatchNorm at scale 1, bias 0,
    mean 0, var 1); load real ones with ``load_state_dict``."""

    def __init__(self, cfg: ResNetConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        block = BasicBlock if cfg.block == "basic" else Bottleneck
        self.conv1 = _conv(3, 64, 7, qcfg, dev, 2, 3)
        self.bn1 = _bn(64, dev)
        c_in, width = 64, 64
        self.blocks = []
        for stage, n_blocks in enumerate(cfg.layers):
            for b in range(n_blocks):
                strides = 2 if (stage > 0 and b == 0) else 1
                downsample = b == 0 and (strides != 1 or
                                         c_in != width * block.expansion)
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(c_in, width, qcfg, strides,
                                            downsample, dev))
                self.blocks.append(name)
                c_in = width * block.expansion
            width *= 2
        self.fc = QuantDense(c_in, cfg.num_classes, qcfg, device=dev)

    def forward(self, x, train: bool = False):
        with tf32_off():
            x = F.relu(self.bn1(self.conv1(x), train))
            x = F.max_pool2d(x, 3, 2, padding=1)
            for name in self.blocks:
                x = getattr(self, name)(x, train)
            return self.fc(x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# torchvision state_dict import
# ---------------------------------------------------------------------------

def _bnp(sd, key):
    return ({"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]},
            {"mean": sd[f"{key}.running_mean"],
             "var": sd[f"{key}.running_var"]})


def import_torchvision_resnet(sd: Mapping, cfg: ResNetConfig):
    """torchvision resnet state dict -> (params, batch_stats), the
    reference's trees in the port's layout: convolution kernels OIHW as
    torchvision stores them, the fc kernel (in, out)."""
    params, stats = {}, {}
    params["conv1"] = {"kernel": sd["conv1.weight"]}
    params["bn1"], stats["bn1"] = _bnp(sd, "bn1")
    n_convs = 2 if cfg.block == "basic" else 3
    for stage, n_blocks in enumerate(cfg.layers):
        for b in range(n_blocks):
            src = f"layer{stage + 1}.{b}"
            p, s = {}, {}
            for ci in range(1, n_convs + 1):
                p[f"conv{ci}"] = {"kernel": sd[f"{src}.conv{ci}.weight"]}
                p[f"bn{ci}"], s[f"bn{ci}"] = _bnp(sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                p["downsample_conv"] = {
                    "kernel": sd[f"{src}.downsample.0.weight"]}
                p["downsample_bn"], s["downsample_bn"] = _bnp(
                    sd, f"{src}.downsample.1")
            params[f"layer{stage + 1}_{b}"], \
                stats[f"layer{stage + 1}_{b}"] = p, s
    params["fc"] = {"kernel": sd["fc.weight"].T, "bias": sd["fc.bias"]}
    return params, stats
