"""Quantized Vision Transformer (torchvision's vit_b_16 and vit_l_16).

Counterpart of the reference's ``models/vit.py``: the patch projection is
a ``QuantConv`` (stride = kernel = patch), each pre-LN encoder block a
``QuantMultiHeadAttention`` (fused in-projection, q/k/v sharing one
quantized input, f32 attention products) and two ``QuantDense`` with the
exact erf GELU between them (``models/bert.py:gelu_erf``, jax.nn.gelu's
cast points); the head is a ``QuantDense`` on the class token. LayerNorm
is flax's (eps 1e-6). Patches are taken in row-major order, as the
reference's NHWC reshape takes them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from .._ext import resolve_device
from ..kernels.qmatmul import tf32_off
from ..nn.config import QuantConfig
from ..nn.layers import QuantConv, QuantDense, QuantMultiHeadAttention
from .bert import gelu_erf
from .transformer_lm import LayerNorm

__all__ = ["ViTConfig", "vit_b_16_config", "vit_l_16_config",
           "EncoderBlock", "ViT", "import_torchvision_vit"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 1000

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_b_16_config():
    return ViTConfig()


def vit_l_16_config():
    return ViTConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)


class EncoderBlock(nn.Module):
    def __init__(self, c: ViTConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(c.d_model, 1e-6, device)
        self.attn = QuantMultiHeadAttention(c.d_model, c.n_heads, qcfg,
                                            device=device)
        self.ln_2 = LayerNorm(c.d_model, 1e-6, device)
        self.mlp_1 = QuantDense(c.d_model, c.d_ff, qcfg, device=device)
        self.mlp_2 = QuantDense(c.d_ff, c.d_model, qcfg, device=device)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp_2(gelu_erf(self.mlp_1(self.ln_2(x))))


class ViT(nn.Module):
    """(B, 3, image_size, image_size) -> (B, num_classes) logits, on
    ``device`` (default "cuda"). ``class_token`` starts at 0 and
    ``pos_embedding`` normal with std 0.02, as the reference's init."""

    def __init__(self, cfg: ViTConfig, qcfg: QuantConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        c = self.cfg = cfg
        self.conv_proj = QuantConv(3, c.d_model, (c.patch_size,) * 2, qcfg,
                                   strides=c.patch_size, padding=0,
                                   device=dev)
        self.class_token = nn.Parameter(torch.zeros((1, 1, c.d_model),
                                                    device=dev))
        self.pos_embedding = nn.Parameter(0.02 * torch.randn(
            (1, c.n_patches + 1, c.d_model), device=dev))
        for i in range(c.n_layers):
            self.add_module(f"encoder_{i}", EncoderBlock(c, qcfg, dev))
        self.ln = LayerNorm(c.d_model, 1e-6, dev)
        self.head = QuantDense(c.d_model, c.num_classes, qcfg, device=dev)

    def forward(self, x, train: bool = False):
        c = self.cfg
        with tf32_off():
            x = self.conv_proj(x)
            B = x.shape[0]
            x = x.flatten(2).transpose(1, 2).reshape(B, c.n_patches,
                                                     c.d_model)
            x = torch.cat([self.class_token.expand(B, 1, c.d_model), x], 1)
            x = x + self.pos_embedding
            for i in range(c.n_layers):
                x = getattr(self, f"encoder_{i}")(x)
            return self.head(self.ln(x)[:, 0])


def import_torchvision_vit(sd: Mapping, cfg: ViTConfig):
    """torchvision vit_b_16 / vit_l_16 state dict -> ViT params in the
    port's layout (the patch kernel OIHW, linear kernels (in, out))."""
    def ln(key):
        return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}

    def lin(key):
        return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}

    params = {
        "conv_proj": {"kernel": sd["conv_proj.weight"],
                      "bias": sd["conv_proj.bias"]},
        "class_token": sd["class_token"].reshape(1, 1, cfg.d_model),
        "pos_embedding": sd["encoder.pos_embedding"],
        "ln": ln("encoder.ln"),
        "head": lin("heads.head"),
    }
    for i in range(cfg.n_layers):
        b = f"encoder.layers.encoder_layer_{i}"
        # torchvision's MLPBlock: a Sequential (linear at 0 and 3) in older
        # versions, linear_1/linear_2 in newer ones
        if f"{b}.mlp.0.weight" in sd:
            m1, m2 = f"{b}.mlp.0", f"{b}.mlp.3"
        else:
            m1, m2 = f"{b}.mlp.linear_1", f"{b}.mlp.linear_2"
        params[f"encoder_{i}"] = {
            "ln_1": ln(f"{b}.ln_1"),
            "ln_2": ln(f"{b}.ln_2"),
            "attn": {
                "in_proj": {
                    "kernel": sd[f"{b}.self_attention.in_proj_weight"].T,
                    "bias": sd[f"{b}.self_attention.in_proj_bias"]},
                "out_proj": lin(f"{b}.self_attention.out_proj"),
            },
            "mlp_1": lin(m1),
            "mlp_2": lin(m2),
        }
    return params
