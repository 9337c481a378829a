"""Quantized layers: ``QuantDense``, a dense layer whose weight and input
are fake-quantized by calibrated states.

Counterpart of the reference's ``nn/layers.py`` (``_QuantSite``,
``QuantDense``). Each layer owns two quantizer states, ``weight_q`` and
``input_q`` (:class:`QuantSite`). The reference's two-phase protocol
maps onto a calibrating mode (:func:`calibrating`, in place of flax's
``mutable=["quant"]``):

1. calibrating: every site whose state is not yet initialized calibrates
   from the current weight and the incoming activations, then the forward
   fake-quantizes with the new state. A state that is initialized is never
   recalibrated (frozen after the first batch); promotion
   (``calibrate/promote.py``) resets the flag. A recalibration keeps the
   previously chosen numeric type (``prev_mode``) and a promoted bit.
2. otherwise: the frozen states fake-quantize.

``quant_tree`` and ``load_quant_tree`` read and set the states as the
reference's quant collection (``{path: {"weight_q", "input_q"}}``) over
every ``QuantDense`` and ``QuantConv`` of a model.

``QuantConv`` keeps torchvision's layout where the reference keeps the
TPU's: NCHW activations and an OIHW ``kernel`` (the reference: NHWC and
HWIO). Its weight site is per channel along O (axis 0) and its OVP pairs
run along the input channels (axis 1; the reference's axis 2 of HWIO),
its input's pairs along the channels (axis 1; the reference's last
axis of NHWC), so a state quantizes the same values at the same logical
positions.
``QuantMultiHeadAttention`` is the reference's: one fused ``in_proj``
(3e outputs, so q, k and v share one quantized input), an ``out_proj``,
and f32 attention products between them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..calibrate.search import apply_quant, calibrate
from ..calibrate.spec import QuantState, SiteConfig, placeholder_state
from ..kernels.qmatmul import tf32_off
from .config import QuantConfig

__all__ = ["QuantSite", "QuantDense", "QuantConv", "QuantMultiHeadAttention",
           "calibrating", "quant_tree", "load_quant_tree"]


class QuantSite:
    """One tensor quantizer: its static config and its state (None when
    the site is disabled: an unquantized model holds no states)."""

    def __init__(self, cfg: SiteConfig, num_channels: Optional[int],
                 device=None):
        self.cfg = cfg
        self.state = (placeholder_state(num_channels, device)
                      if cfg.enabled else None)

    def __call__(self, x: torch.Tensor, calibrating: bool) -> torch.Tensor:
        if not self.cfg.enabled:
            return x
        st = self.state
        if calibrating and not bool(st.initialized):
            bit = int(st.bit)
            # a promoted bit is sticky; a previously chosen type (bit > 0
            # marks a calibrated state) is pinned
            promoted = bit >= 8 if self.cfg.bit < 8 else False
            prev_mode = int(st.mode_idx) if bit > 0 else -1
            with torch.no_grad():
                self.state = calibrate(x.detach().to(torch.float32),
                                       self.cfg, promoted=promoted,
                                       prev_mode=prev_mode)
        q = apply_quant(x.to(torch.float32), self.state, self.cfg)
        return q.to(x.dtype)


class QuantDense(nn.Module):
    """Quantized dense layer: ``kernel`` (in, features) and ``bias``, as
    the reference's flax layer. The weight is quantized per output channel
    and signed, the input per tensor; OVP pairs run along the reduction
    axis. GPT-2's Conv1D sites pass ``channel_axis=0, pair_axis=1`` (per
    input channel, pairs along the output axis). The product runs in
    ``dtype`` (default ``qcfg.compute_dtype``) without TF32."""

    def __init__(self, in_features: int, features: int, qcfg: QuantConfig,
                 use_bias: bool = True, dtype: Any = None,
                 channel_axis: int = -1, pair_axis: int = 0, device=None):
        super().__init__()
        self.qcfg = qcfg
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty((in_features, features),
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros((features,), device=device))
                     if use_bias else None)
        self.weight_q = QuantSite(
            qcfg.weight_site(channel_axis=channel_axis, pair_axis=pair_axis),
            self.kernel.shape[channel_axis], device)
        self.input_q = QuantSite(qcfg.input_site(), None, device)
        self.calibrating = False
        nn.init.normal_(self.kernel, std=1.0 / math.sqrt(in_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qk = self.weight_q(self.kernel, self.calibrating)
        qx = self.input_q(x, self.calibrating)
        dtype = self.dtype or self.qcfg.compute_dtype
        with tf32_off():
            y = torch.matmul(qx.to(dtype), qk.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def _pairs(v, n: int = 2) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


def conv_padding(padding, in_hw: Sequence[int], kernel_size, strides):
    """The reference's padding argument (an int, "SAME", "VALID" or
    ((top, bottom), (left, right))) as explicit ((lo, hi), (lo, hi)) per
    spatial dim; "SAME" as XLA pads it (the odd pixel at the end)."""
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        pads = []
        for n, k, s in zip(in_hw, kernel_size, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return tuple(tuple(int(v) for v in p) for p in padding)


class QuantConv(nn.Module):
    """Quantized 2-D convolution: NCHW ``x``, ``kernel`` (features,
    in_channels / feature_group_count, kh, kw) and ``bias`` (added after
    the convolution, as the reference adds it). ``padding`` takes the
    reference's forms (:func:`conv_padding`). The product runs in
    ``dtype`` (default ``qcfg.compute_dtype``) without TF32."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int], qcfg: QuantConfig,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Any = "SAME", feature_group_count: int = 1,
                 use_bias: bool = True, dtype: Any = None, device=None):
        super().__init__()
        self.qcfg = qcfg
        self.dtype = dtype
        self.kernel_size = _pairs(kernel_size)
        self.strides = _pairs(strides)
        self.padding = padding
        self.groups = feature_group_count
        fan_in = in_channels // feature_group_count
        self.kernel = nn.Parameter(torch.empty(
            (features, fan_in, *self.kernel_size), device=device))
        self.bias = (nn.Parameter(torch.zeros((features,), device=device))
                     if use_bias else None)
        self.weight_q = QuantSite(
            qcfg.weight_site(channel_axis=0, pair_axis=1), features, device)
        # OVP pairs of the input run along the channels, as the
        # reference's last (channel) axis of NHWC
        self.input_q = QuantSite(qcfg.input_site(pair_axis=1), None, device)
        self.calibrating = False
        nn.init.normal_(self.kernel, std=1.0 / math.sqrt(
            fan_in * self.kernel_size[0] * self.kernel_size[1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qk = self.weight_q(self.kernel, self.calibrating)
        qx = self.input_q(x, self.calibrating)
        dtype = self.dtype or self.qcfg.compute_dtype
        (t, b), (l, r) = conv_padding(self.padding, x.shape[2:],
                                      self.kernel_size, self.strides)
        qx = qx.to(dtype)
        if t != b or l != r:
            qx = F.pad(qx, (l, r, t, b))
            t = l = 0
        with tf32_off():
            y = F.conv2d(qx, qk.to(dtype), None, self.strides, (t, l), 1,
                         self.groups)
        if self.bias is not None:
            y = y + self.bias.to(dtype)[:, None, None]
        return y


class QuantMultiHeadAttention(nn.Module):
    """Quantized self-attention over (..., L, e) ``x``: ``in_proj`` (e ->
    3e) and ``out_proj`` (e -> e) are ``QuantDense``; the scores (divided
    by sqrt(head_dim)), the softmax and the weighted sum stay f32. A
    boolean ``mask`` (broadcast to (..., heads, L, L)) keeps the scores
    where true and puts the f32 minimum elsewhere."""

    def __init__(self, e: int, num_heads: int, qcfg: QuantConfig,
                 dtype: Any = None, device=None):
        super().__init__()
        assert e % num_heads == 0
        self.num_heads = num_heads
        self.in_proj = QuantDense(e, 3 * e, qcfg, dtype=dtype, device=device)
        self.out_proj = QuantDense(e, e, qcfg, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        e = x.shape[-1]
        hd = e // self.num_heads
        q, k, v = (t.reshape(*t.shape[:-1], self.num_heads, hd)
                   for t in self.in_proj(x).split(e, dim=-1))
        div = torch.tensor(float(np.float32(np.sqrt(hd))), dtype=q.dtype,
                           device=x.device)
        with tf32_off():
            scores = torch.einsum("...qhd,...khd->...hqk", q, k) / div
            if mask is not None:
                scores = torch.where(mask, scores,
                                     torch.finfo(scores.dtype).min)
            attn = torch.softmax(scores, dim=-1)
            out = torch.einsum("...hqk,...khd->...qhd", attn, v)
        return self.out_proj(out.reshape(*out.shape[:-2], e))


def _site_layers(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (QuantDense, QuantConv))]


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Run the block with every QuantDense and QuantConv of ``model``
    calibrating."""
    layers = [m for _, m in _site_layers(model)]
    for m in layers:
        m.calibrating = True
    try:
        yield model
    finally:
        for m in layers:
            m.calibrating = False


def quant_tree(model: nn.Module) -> Dict:
    """The states of ``model`` as the reference's quant collection: nested
    dicts by module path, each site ``{"weight_q": ..., "input_q": ...}``
    (a disabled site has none)."""
    tree: Dict = {}
    for name, m in _site_layers(model):
        site = {k: s.state for k, s in (("weight_q", m.weight_q),
                                        ("input_q", m.input_q))
                if s.state is not None}
        if not site:
            continue
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        if name:
            node[last] = site
        else:                       # the model is the layer
            node.update(site)
    return tree


def load_quant_tree(model: nn.Module, tree: Dict) -> None:
    """Set the states of ``model`` from a quant collection (moved to each
    layer's device)."""
    for name, m in _site_layers(model):
        node = tree
        for part in (name.split(".") if name else ()):
            node = node[part]
        for key in ("weight_q", "input_q"):
            if key in node:
                st: QuantState = node[key]
                getattr(m, key).state = st.to(m.kernel.device)
