"""GOBO-style outlier baseline mode ("outlier" in the reference CLIs).

Counterpart of the reference's ``ops/outlier.py``: a percentile of |x|
splits the tensor; values at or below it snap on the int grid at that
threshold's scale, values above it get a 16-bit affine quantization of
the magnitude between the threshold and absmax. STE on both paths.

The percentile is the reference's ``jnp.percentile`` (linear method) in
f32 as XLA compiles it inside the reference's jitted calibration, where
the percent is a constant: the position ``f32(p / 100) * (n - 1)`` in
f32 (p = percent * 100), the order statistics at its floor and ceiling,
and ``low (1 - w) + high w``, which XLA:CPU contracts to ``fma(low,
1 - w, high w)``: one rounding for the low product and the sum (here in
f64, where the product of two f32 values is exact). Called with the
percent as a traced argument, XLA folds both steps otherwise (``p *
(0.01 (n - 1))`` and ``fma(high, w, low (1 - w))``): at n = 12,345 and
p = 99.9 the positions are 12331.656 and 12331.655.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .snap import snap_value_search

__all__ = ["outlier_thresholds", "percentile_linear", "outlier_fake_quant"]


def percentile_linear(a: torch.Tensor, percent: float) -> torch.Tensor:
    """``jnp.percentile(a, percent * 100)`` of a flat f32 tensor under
    the reference's jit (``percent`` in [0, 1], a constant there)."""
    a = a.reshape(-1).to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    n = f32(float(a.numel()))
    pos = (f32(percent * 100.0) / f32(100.0)) * (n - f32(1.0))
    low = torch.clamp(torch.floor(pos), f32(0.0), n - f32(1.0))
    high = torch.clamp(torch.ceil(pos), f32(0.0), n - f32(1.0))
    hw = pos - torch.floor(pos)
    lw = f32(1.0) - hw
    lo_v = torch.kthvalue(a, int(low) + 1).values
    hi_v = torch.kthvalue(a, int(high) + 1).values
    hi_term = hi_v * hw.to(a.device)
    return (lo_v.double() * lw.to(a.device).double()
            + hi_term.double()).to(torch.float32)


def outlier_thresholds(x: torch.Tensor,
                       percent: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(percentile |x| value, absmax |x|); ``percent`` in [0, 1]."""
    ax = x.abs().reshape(-1)
    return percentile_linear(ax, percent), ax.max()


def outlier_fake_quant(x: torch.Tensor, grid: torch.Tensor,
                       t4: torch.Tensor, t16: torch.Tensor, percent: float,
                       is_signed) -> torch.Tensor:
    """Two-level fake quant; ``is_signed`` may be a bool tensor (the
    calibrated signedness)."""
    grid = grid.to(x.device)
    t4 = torch.as_tensor(t4, dtype=x.dtype, device=x.device)
    t16 = torch.as_tensor(t16, dtype=x.dtype, device=x.device)
    mask16 = x.abs() > t4
    scale = t4 / grid.max()
    int4 = snap_value_search(x / scale, grid) * scale
    inner = torch.where(t4 > 0, int4, x)
    inner = x + (inner - x).detach()
    if percent >= 1.0:
        return inner
    level = torch.where(torch.as_tensor(is_signed, device=x.device),
                        torch.tensor(2.0 ** 16 - 1, device=x.device),
                        torch.tensor(2.0 ** 15 - 1, device=x.device))
    scale16 = (t16 - t4) / level
    mag = x.abs() - t4
    q16 = torch.round(mag / scale16) * scale16 + t4
    q16 = q16 * torch.sign(x)
    outer = x + (q16 - x).detach()
    return torch.where(mask16, outer, inner)
