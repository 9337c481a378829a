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
reference's quant collection (``{path: {"weight_q", "input_q"}}``).
The BERT and BART encoders (``models/bert.py``, ``models/bart.py``) use
``QuantDense`` alone. ``QuantConv`` and ``QuantMultiHeadAttention`` come
with the image models, which alone use them (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..calibrate.search import apply_quant, calibrate
from ..calibrate.spec import QuantState, SiteConfig, placeholder_state
from ..kernels.qmatmul import tf32_off
from .config import QuantConfig

__all__ = ["QuantSite", "QuantDense", "calibrating", "quant_tree",
           "load_quant_tree"]


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


def _dense_layers(model: nn.Module):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, QuantDense)]


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Run the block with every QuantDense of ``model`` calibrating."""
    layers = [m for _, m in _dense_layers(model)]
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
    for name, m in _dense_layers(model):
        site = {k: s.state for k, s in (("weight_q", m.weight_q),
                                        ("input_q", m.input_q))
                if s.state is not None}
        if not site:
            continue
        node = tree
        for part in name.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[name.split(".")[-1]] = site
    return tree


def load_quant_tree(model: nn.Module, tree: Dict) -> None:
    """Set the states of ``model`` from a quant collection (moved to each
    layer's device)."""
    for name, m in _dense_layers(model):
        node = tree
        for part in name.split("."):
            node = node[part]
        for key in ("weight_q", "input_q"):
            if key in node:
                st: QuantState = node[key]
                getattr(m, key).state = st.to(m.kernel.device)
