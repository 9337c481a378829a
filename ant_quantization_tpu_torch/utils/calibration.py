"""Model-level calibration.

Counterpart of the reference's ``utils/calibration.py``: one calibration
forward that returns (output, quant tree). Calibration keeps the
reference's cascade: layer i calibrates its weight and input before
layer i + 1 sees its activations, so later layers calibrate on
fake-quantized upstream outputs. It runs eagerly on the model's own
device (the reference's hop to the host CPU backend has no counterpart).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn.layers import calibrating, load_quant_tree, quant_tree

__all__ = ["calibrate_model"]


def calibrate_model(model: nn.Module, *args, quant: Optional[Dict] = None,
                    **kwargs):
    """Run one calibration forward of ``model``; returns (output, quant
    tree). ``quant``: states to start from (the reference's previous
    'quant' collection, for a promotion-aware recalibration); without it
    the model's current states."""
    if quant is not None:
        load_quant_tree(model, quant)
    with torch.no_grad(), calibrating(model):
        out = model(*args, **kwargs)
    return out, quant_tree(model)
