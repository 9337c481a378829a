"""Quantized Inception-v3 (torchvision's architecture, aux_logits=False).

Counterpart of the reference's ``models/inception.py``: every
convolution is a ``ConvBN`` (a ``QuantConv`` without bias, ``BatchNorm``
with eps 1e-3 and momentum 0.9, ReLU), blocks A-E under torchvision's
names, and a ``QuantDense`` fc: 94 convolutions and the fc, 95 quantized
sites. The "same" average pools count their padding (``count_include_pad
=True``), the max pools pad nothing. Branches concatenate along the
channels of NCHW activations in the reference's order. Input is 299 px
(75 px is the smallest its strides allow).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .._ext import resolve_device
from ..kernels.qmatmul import tf32_off
from ..nn.config import QuantConfig
from ..nn.layers import QuantConv, QuantDense
from .resnet import BatchNorm

__all__ = ["BN_EPS", "InceptionConfig", "inception_v3_config", "ConvBN",
           "InceptionA", "InceptionB", "InceptionC", "InceptionD",
           "InceptionE", "InceptionV3", "import_torchvision_inception"]

BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    num_classes: int = 1000


def inception_v3_config(**kw) -> InceptionConfig:
    return InceptionConfig(**kw)


class ConvBN(nn.Module):
    """torchvision BasicConv2d: conv (no bias) + BN + ReLU. ``padding``:
    an int, or (ph, pw) padded on both sides of each dim."""

    def __init__(self, c_in: int, features: int,
                 kernel_size: Tuple[int, int], qcfg: QuantConfig,
                 strides: int = 1, padding=0, device=None):
        super().__init__()
        if isinstance(padding, tuple) and isinstance(padding[0], int):
            padding = ((padding[0], padding[0]), (padding[1], padding[1]))
        self.conv = QuantConv(c_in, features, kernel_size, qcfg,
                              strides=strides, padding=padding,
                              use_bias=False, device=device)
        self.bn = BatchNorm(features, momentum=0.9, eps=BN_EPS,
                            device=device)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


def _pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class _Block(nn.Module):
    """A block of named ConvBN branches; ``spec`` rows are (name, c_in,
    features, kernel, strides, padding), c_in None for the block's
    input channels."""

    def __init__(self, c_in: int, spec: Sequence, qcfg, device):
        super().__init__()
        for name, ci, co, k, s, p in spec:
            self.add_module(name, ConvBN(c_in if ci is None else ci, co, k,
                                         qcfg, s, p, device))

    def run(self, name, x, train):
        return getattr(self, name)(x, train)


class InceptionA(_Block):
    def __init__(self, c_in: int, qcfg: QuantConfig, pool_features: int,
                 device=None):
        super().__init__(c_in, (
            ("branch1x1", None, 64, (1, 1), 1, 0),
            ("branch5x5_1", None, 48, (1, 1), 1, 0),
            ("branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
            ("branch3x3dbl_1", None, 64, (1, 1), 1, 0),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
            ("branch_pool", None, pool_features, (1, 1), 1, 0)),
            qcfg, device)

    def forward(self, x, train=False):
        r = self.run
        b1 = r("branch1x1", x, train)
        b5 = r("branch5x5_2", r("branch5x5_1", x, train), train)
        b3 = r("branch3x3dbl_1", x, train)
        b3 = r("branch3x3dbl_3", r("branch3x3dbl_2", b3, train), train)
        bp = r("branch_pool", _pool_same(x), train)
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    def __init__(self, c_in: int, qcfg: QuantConfig, device=None):
        super().__init__(c_in, (
            ("branch3x3", None, 384, (3, 3), 2, 0),
            ("branch3x3dbl_1", None, 64, (1, 1), 1, 0),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3", 96, 96, (3, 3), 2, 0)), qcfg, device)

    def forward(self, x, train=False):
        r = self.run
        b3 = r("branch3x3", x, train)
        bd = r("branch3x3dbl_1", x, train)
        bd = r("branch3x3dbl_3", r("branch3x3dbl_2", bd, train), train)
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(_Block):
    def __init__(self, c_in: int, qcfg: QuantConfig, channels_7x7: int,
                 device=None):
        c7 = channels_7x7
        super().__init__(c_in, (
            ("branch1x1", None, 192, (1, 1), 1, 0),
            ("branch7x7_1", None, c7, (1, 1), 1, 0),
            ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_1", None, c7, (1, 1), 1, 0),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            ("branch_pool", None, 192, (1, 1), 1, 0)), qcfg, device)

    def forward(self, x, train=False):
        r = self.run
        b1 = r("branch1x1", x, train)
        b7 = x
        for n in ("branch7x7_1", "branch7x7_2", "branch7x7_3"):
            b7 = r(n, b7, train)
        bd = x
        for i in range(1, 6):
            bd = r(f"branch7x7dbl_{i}", bd, train)
        bp = r("branch_pool", _pool_same(x), train)
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    def __init__(self, c_in: int, qcfg: QuantConfig, device=None):
        super().__init__(c_in, (
            ("branch3x3_1", None, 192, (1, 1), 1, 0),
            ("branch3x3_2", 192, 320, (3, 3), 2, 0),
            ("branch7x7x3_1", None, 192, (1, 1), 1, 0),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            ("branch7x7x3_4", 192, 192, (3, 3), 2, 0)), qcfg, device)

    def forward(self, x, train=False):
        r = self.run
        b3 = r("branch3x3_2", r("branch3x3_1", x, train), train)
        b7 = x
        for i in range(1, 5):
            b7 = r(f"branch7x7x3_{i}", b7, train)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(_Block):
    def __init__(self, c_in: int, qcfg: QuantConfig, device=None):
        super().__init__(c_in, (
            ("branch1x1", None, 320, (1, 1), 1, 0),
            ("branch3x3_1", None, 384, (1, 1), 1, 0),
            ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch3x3dbl_1", None, 448, (1, 1), 1, 0),
            ("branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch_pool", None, 192, (1, 1), 1, 0)), qcfg, device)

    def forward(self, x, train=False):
        r = self.run
        b1 = r("branch1x1", x, train)
        b3 = r("branch3x3_1", x, train)
        b3 = torch.cat([r("branch3x3_2a", b3, train),
                        r("branch3x3_2b", b3, train)], dim=1)
        bd = r("branch3x3dbl_2", r("branch3x3dbl_1", x, train), train)
        bd = torch.cat([r("branch3x3dbl_3a", bd, train),
                        r("branch3x3dbl_3b", bd, train)], dim=1)
        bp = r("branch_pool", _pool_same(x), train)
        return torch.cat([b1, b3, bd, bp], dim=1)


_STEM = (("Conv2d_1a_3x3", 3, 32, 2, 0), ("Conv2d_2a_3x3", 32, 32, 1, 0),
         ("Conv2d_2b_3x3", 32, 64, 1, (1, 1)))
_STEM2 = (("Conv2d_3b_1x1", 64, 80, (1, 1)), ("Conv2d_4a_3x3", 80, 192,
                                               (3, 3)))


class InceptionV3(nn.Module):
    """(B, 3, 299, 299) -> (B, num_classes) logits, on ``device`` (default
    "cuda")."""

    def __init__(self, cfg: InceptionConfig, qcfg: QuantConfig,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        q = qcfg
        self.cfg = cfg
        for name, ci, co, s, p in _STEM:
            self.add_module(name, ConvBN(ci, co, (3, 3), q, s, p, dev))
        for name, ci, co, k in _STEM2:
            self.add_module(name, ConvBN(ci, co, k, q, device=dev))
        self.Mixed_5b = InceptionA(192, q, 32, dev)
        self.Mixed_5c = InceptionA(256, q, 64, dev)
        self.Mixed_5d = InceptionA(288, q, 64, dev)
        self.Mixed_6a = InceptionB(288, q, dev)
        self.Mixed_6b = InceptionC(768, q, 128, dev)
        self.Mixed_6c = InceptionC(768, q, 160, dev)
        self.Mixed_6d = InceptionC(768, q, 160, dev)
        self.Mixed_6e = InceptionC(768, q, 192, dev)
        self.Mixed_7a = InceptionD(768, q, dev)
        self.Mixed_7b = InceptionE(1280, q, dev)
        self.Mixed_7c = InceptionE(2048, q, dev)
        self.fc = QuantDense(2048, cfg.num_classes, q, device=dev)

    def forward(self, x, train: bool = False):
        with tf32_off():
            for name, *_ in _STEM:
                x = getattr(self, name)(x, train)
            x = F.max_pool2d(x, 3, 2)
            for name, *_ in _STEM2:
                x = getattr(self, name)(x, train)
            x = F.max_pool2d(x, 3, 2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                         "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x, train)
            return self.fc(x.mean(dim=(2, 3)))


# ---------------------------------------------------------------------------
# torchvision import
# ---------------------------------------------------------------------------

def import_torchvision_inception(sd: Mapping, cfg: InceptionConfig):
    """torchvision inception_v3 state dict (aux_logits keys ignored) ->
    (params, batch_stats) in the port's layout (OIHW kernels, the fc
    kernel (in, out))."""
    params: dict = {}
    stats: dict = {}

    def convbn(src: str):
        return ({"conv": {"kernel": sd[f"{src}.conv.weight"]},
                 "bn": {"scale": sd[f"{src}.bn.weight"],
                        "bias": sd[f"{src}.bn.bias"]}},
                {"bn": {"mean": sd[f"{src}.bn.running_mean"],
                        "var": sd[f"{src}.bn.running_var"]}})

    def block(name: str, branches: Sequence[str]):
        params[name], stats[name] = {}, {}
        for b in branches:
            params[name][b], stats[name][b] = convbn(f"{name}.{b}")

    for name, *_ in _STEM + _STEM2:
        params[name], stats[name] = convbn(name)
    a_branches = ("branch1x1", "branch5x5_1", "branch5x5_2",
                  "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3",
                  "branch_pool")
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        block(name, a_branches)
    block("Mixed_6a", ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                       "branch3x3dbl_3"))
    c_branches = ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                  "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                  "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool")
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        block(name, c_branches)
    block("Mixed_7a", ("branch3x3_1", "branch3x3_2", "branch7x7x3_1",
                       "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"))
    e_branches = ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                  "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
                  "branch3x3dbl_3b", "branch_pool")
    for name in ("Mixed_7b", "Mixed_7c"):
        block(name, e_branches)
    params["fc"] = {"kernel": sd["fc.weight"].T, "bias": sd["fc.bias"]}
    return params, stats
