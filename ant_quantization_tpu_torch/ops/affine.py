"""Asymmetric affine quantization helpers.

Counterpart of the reference's ``ops/affine.py``: linear quantize and
dequantize with an affine scale and zero point from a min/max range, and
a straight-through wrapper, ``ste_affine_quantize``, here a
``torch.autograd.Function`` whose backward passes the gradient through
(the reference's ``jax.custom_vjp``). Constants enter as tensors, so a
division stays a division on every device.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["affine_params", "linear_quantize", "linear_dequantize",
           "fake_affine_quantize", "ste_affine_quantize"]


def _c(like: torch.Tensor, v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def affine_params(x_min: torch.Tensor, x_max: torch.Tensor,
                  bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, zero_point) of [x_min, x_max] onto [0, 2^bits - 1]; a
    collapsed range gives scale 1."""
    rng = x_max - x_min
    scale = torch.where(rng > 0, _c(rng, 2 ** bits - 1) / rng, _c(rng, 1.0))
    return scale, scale * x_min


def linear_quantize(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Round (half to even) to the integer grid, clamp to [0, 2^bits-1]."""
    q = torch.round(scale * x - zp)
    return torch.clamp(q, _c(q, 0.0), _c(q, 2 ** bits - 1))


def linear_dequantize(q: torch.Tensor, scale: torch.Tensor,
                      zp: torch.Tensor) -> torch.Tensor:
    return (q + zp) / scale


def fake_affine_quantize(x: torch.Tensor, bits: int, x_min=None,
                         x_max=None) -> torch.Tensor:
    """Quantize-dequantize through the affine grid (per tensor unless
    min/max of broadcastable shapes are given)."""
    x_min = x.min() if x_min is None else torch.as_tensor(x_min,
                                                          device=x.device)
    x_max = x.max() if x_max is None else torch.as_tensor(x_max,
                                                          device=x.device)
    scale, zp = affine_params(x_min, x_max, bits)
    return linear_dequantize(linear_quantize(x, scale, zp, bits), scale, zp)


class _SteAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        return fake_affine_quantize(x, bits)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_affine_quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Fake affine quantization with a straight-through gradient."""
    return _SteAffine.apply(x, bits)
