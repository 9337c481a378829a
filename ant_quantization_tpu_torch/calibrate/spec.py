"""Quantizer state and static site configuration.

Counterpart of the reference's ``calibrate/spec.py``. ``QuantState`` is a
dataclass of tensors (the reference's flax struct), immutable in use:
``replace`` makes a changed copy, ``numpy`` exports the leaves and
``to`` moves them. Grids keep a fixed storage size, padded by repeating
the maximum entry (a snap is unchanged by duplicate entries), so 4- and
8-bit states have the same shapes and promotion is a change of leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..numerics import codebooks as cb

__all__ = ["GRID_PAD", "OUTLIER_PAD", "QuantState", "SiteConfig",
           "pad_grid", "placeholder_state"]

GRID_PAD = 256          # 2^8, the largest grid
OUTLIER_PAD = 256       # the OliVe abfloat grid (<= 254 entries at 8-bit)


@dataclasses.dataclass(frozen=True)
class QuantState:
    """Calibrated state of one tensor quantizer."""
    alpha: torch.Tensor        # () per tensor or (C,) per channel
    grid: torch.Tensor         # (GRID_PAD,) integer-domain codebook, sorted
    outliers: torch.Tensor     # (OUTLIER_PAD,) OliVe outlier grid (zeros
                               # for ANT)
    bit: torch.Tensor          # () int32: 4/6/8 (0 before calibration)
    mode_idx: torch.Tensor     # () int32 index into ANT_MODES
    is_signed: torch.Tensor    # () bool
    mse: torch.Tensor          # () f32 calibration MSE (promotion ranking)
    initialized: torch.Tensor  # () bool
    aux: torch.Tensor          # () f32: the absmax threshold of the GOBO
                               # "outlier" mode (unused otherwise)

    def replace(self, **kw) -> "QuantState":
        return dataclasses.replace(self, **kw)

    def numpy(self) -> Dict[str, np.ndarray]:
        """The leaves as numpy arrays, by field name."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}

    def to(self, device) -> "QuantState":
        return QuantState(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SiteConfig:
    """Static configuration of one quantizer site: the reference
    Quantizer's constructor arguments and global quant args, minus
    anything data-dependent."""
    bit: int = 4                      # default bit-width (pre-promotion)
    is_input: bool = False            # activations: per-tensor, unsigned init
    is_signed: bool = True            # initial signedness (may flip up)
    mode: str = "ant-int-pot-flint"   # mode string, reference CLI semantics
    family: str = "ant"               # "ant" | "olive"
    # alpha-scan bounds, in percent (w_* for weights, a_* for inputs)
    w_low: int = 75
    w_up: int = 150
    a_low: int = 75
    a_up: int = 150
    scan_step: int = 1                # 1 for ANT, 2 for OliVe
    no_outlier: bool = False          # OliVe: no OVP, no 3-sigma init
    channel_axis: int = -1            # weight per-channel axis (out)
    pair_axis: int = 0                # OVP pairing axis (in)
    percent: float = 1.0              # GOBO outlier-mode percentile [0,1]
    enabled: bool = True

    @property
    def candidate_modes(self) -> Tuple[str, ...]:
        """Candidate numeric types in the search order; a non-adaptive
        mode is itself."""
        if self.mode.startswith("ant-"):
            return tuple(m for m in cb.ANT_MODES if f"-{m}" in self.mode)
        return (self.mode,)

    @property
    def low(self) -> int:
        return self.a_low if self.is_input else self.w_low

    @property
    def up(self) -> int:
        return self.a_up if self.is_input else self.w_up

    @property
    def per_channel(self) -> bool:
        # inputs are quantized per tensor
        return not self.is_input

    @property
    def use_ovp(self) -> bool:
        return self.family == "olive" and not self.no_outlier


def pad_grid(grid: np.ndarray, size: int = GRID_PAD) -> np.ndarray:
    """Pad a sorted grid to ``size`` by repeating its maximum entry."""
    if grid.shape[0] > size:
        raise ValueError(f"grid of {grid.shape[0]} exceeds pad {size}")
    return np.pad(grid, (0, size - grid.shape[0]), mode="edge")


def placeholder_state(num_channels: Optional[int],
                      device=None) -> QuantState:
    """Uninitialized state (before calibration)."""
    t = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    return QuantState(
        alpha=torch.ones((num_channels,) if num_channels else (),
                         device=device),
        grid=torch.ones((GRID_PAD,), device=device),
        outliers=torch.zeros((OUTLIER_PAD,), device=device),
        bit=t(0, torch.int32), mode_idx=t(0, torch.int32),
        is_signed=t(False, torch.bool), mse=t(0.0, torch.float32),
        initialized=t(False, torch.bool), aux=t(0.0, torch.float32))
