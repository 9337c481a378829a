"""Fake quantization (ANT and OliVe) with straight-through gradients.

Counterpart of the reference's ``ops/fake_quant.py``:

    scale = alpha / max(grid)          (the integer-domain grid)
    q     = snap(x / scale, grid)
    out   = (xs + (q - xs).detach()) * scale,   xs = x / scale

The straight-through estimator (STE) is ``xs + (q - xs).detach()``, as
the reference's ``xs + stop_gradient(q - xs)``: the forward value keeps
that sum's rounding, and gradients reach x and alpha through xs and the
scale only. OliVe snaps onto the normal grid || outlier grid concat and
zeroes each outlier's pair neighbour (``ops/ovp.py``) before the STE.

Per-channel alpha broadcasts along ``channel_axis``. Snaps run by binary
search (``ops/snap.py``: ``snap_value_search``, ``snap_concat_value_
search``), with the values of the reference's select chains.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ovp import apply_ovp
from .snap import snap_concat_value_search, snap_uniform, snap_value_search

__all__ = ["ant_fake_quant", "olive_fake_quant", "expand_alpha"]


def _promoted(dyn_bit) -> bool:
    return dyn_bit is not None and int(dyn_bit) > 6


def _snap_sized(xs: torch.Tensor, grid: torch.Tensor,
                static_bit: Optional[int], dyn_bit) -> torch.Tensor:
    """Snap against a padded storage grid at the cost of its real size:
    ``static_bit`` None snaps on the whole grid; above 6 bits (and for a
    state promoted past 6 bits, ``dyn_bit``) the grid is the uniform int
    codebook and takes :func:`snap_uniform`; else the first 2^static_bit
    entries. The reference computes both of the last two and selects by
    ``dyn_bit``; the branch gives the same values."""
    if static_bit is None:
        return snap_value_search(xs, grid)
    if static_bit > 6 or _promoted(dyn_bit):
        return snap_uniform(xs, grid)[0]
    return snap_value_search(xs, grid[: 2 ** static_bit])


def expand_alpha(alpha, ndim: int, channel_axis: Optional[int],
                 device=None) -> torch.Tensor:
    """A per-channel alpha (C,) shaped to broadcast along
    ``channel_axis`` of an ndim-rank tensor; a scalar alpha passes."""
    alpha = torch.as_tensor(alpha, device=device)
    if channel_axis is None:
        return alpha
    shape = [1] * ndim
    shape[channel_axis] = alpha.shape[0] if alpha.ndim else 1
    return alpha.reshape(shape)


def _ste(xs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward value q (as xs + (q - xs)), gradient of identity at xs."""
    return xs + (q - xs).detach()


def ant_fake_quant(x: torch.Tensor, grid: torch.Tensor, alpha,
                   channel_axis: Optional[int] = None,
                   static_bit: Optional[int] = None,
                   dyn_bit=None) -> torch.Tensor:
    """ANT fake quantization. ``static_bit``/``dyn_bit``: the site's
    configured bit and the state's (maybe promoted) bit, see
    :func:`_snap_sized`."""
    grid = grid.to(x.device)
    a = expand_alpha(alpha, x.ndim, channel_axis, x.device)
    scale = a / grid.max()
    xs = x / scale
    q = _snap_sized(xs, grid, static_bit, dyn_bit)
    return _ste(xs, q) * scale


def olive_fake_quant(x: torch.Tensor, grid: torch.Tensor,
                     outliers: Optional[torch.Tensor], alpha,
                     channel_axis: Optional[int] = None,
                     pair_axis: int = -1, static_bit: Optional[int] = None,
                     dyn_bit=None) -> torch.Tensor:
    """OliVe fake quantization with outlier-victim pairs along
    ``pair_axis``. ``outliers=None`` is the no-outlier mode (the plain
    snap on the normal grid). The scale uses the normal grid's max. The
    concat takes the first 2^static_bit entries of both storage grids,
    or all of them (``static_bit`` None, above 6, or a promoted state)."""
    grid = grid.to(x.device)
    a = expand_alpha(alpha, x.ndim, channel_axis, x.device)
    scale = a / grid.max()
    xs = x / scale
    if outliers is None:
        q = _snap_sized(xs, grid, static_bit, dyn_bit)
    else:
        outliers = outliers.to(device=x.device, dtype=grid.dtype)
        if static_bit is not None and static_bit <= 6 \
                and not _promoted(dyn_bit):
            n = 2 ** static_bit
            full = torch.cat([grid[:n], outliers[:n]])
        else:
            full = torch.cat([grid, outliers])
        q = apply_ovp(snap_concat_value_search(xs, full),
                      pair_axis=pair_axis)
    return _ste(xs, q) * scale
