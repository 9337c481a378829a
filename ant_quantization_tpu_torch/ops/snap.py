"""Grid snap: map every element to its nearest entry of a grid.

Counterpart of the reference's ``ops/snap.py`` (``snap_codes``,
``snap_value``, ``snap``, ``snap_concat``, ``snap_concat_value``). The
rule is a compare against the G-1 midpoints ``(g[i] + g[i+1]) * 0.5``,
taken in the input's dtype: ``x >= mid`` moves to the larger entry, so
exact midpoint ties go to the larger value (the original CUDA
extension's ``<=`` scan). ``searchsorted`` is not used: its tie rule
differs.

OliVe's concatenated normal + outlier grid is not sorted. The CUDA scan
breaks a distance tie toward the entry that comes later in the
concatenation, so the ``snap_concat`` pair sorts the grid stably and
carries, per midpoint, whether the later entry is the larger one
(``tie_hi``): ``x > mid``, or ``x == mid`` where ``tie_hi``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["snap_codes", "snap_value", "snap", "snap_concat",
           "snap_concat_value"]


def _mids(grid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    g = grid.to(dtype)
    return (g[1:] + g[:-1]) * 0.5


def _midpoint_codes(x: torch.Tensor, grid: torch.Tensor,
                    tie_hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes = #{i : x > mid_i, or x == mid_i and tie_hi[i]}; without
    ``tie_hi`` every exact midpoint tie takes the larger neighbour."""
    mids = _mids(grid, x.dtype)
    idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(mids.shape[0]):
        if tie_hi is None:
            take = x >= mids[i]
        else:
            take = (x > mids[i]) | ((x == mids[i]) & tie_hi[i])
        idx += take.to(torch.int32)
    return idx


def snap_codes(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Index (int32) into ``grid`` (sorted ascending) of each element's
    nearest entry, ties going to the larger entry."""
    return _midpoint_codes(x, grid)


def snap(x: torch.Tensor,
         grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Snap ``x`` onto a sorted ``grid``: (values in x's dtype, codes)."""
    codes = snap_codes(x, grid)
    return grid.to(x.dtype)[codes.long()], codes


def snap_value(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Snapped values (in x's dtype), same midpoint rule as
    :func:`snap_codes`."""
    g = grid.to(x.dtype)
    mids = (g[1:] + g[:-1]) * 0.5
    out = g[0].expand(x.shape).clone()
    for i in range(mids.shape[0]):
        out = torch.where(x >= mids[i], g[i + 1], out)
    return out


def _concat_order(grid: torch.Tensor, dtype: torch.dtype):
    """The stably sorted grid and its per-midpoint tie flags."""
    g = grid.to(dtype)
    order = torch.argsort(g, stable=True)      # original concat positions
    return g[order], order[1:] >= order[:-1]


def snap_concat(x: torch.Tensor,
                grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Snap onto an *unsorted* grid with the CUDA scan's tie rule.
    Returns (values, codes) with codes indexing the *sorted* grid."""
    sg, tie_hi = _concat_order(grid, x.dtype)
    codes = _midpoint_codes(x, sg, tie_hi=tie_hi)
    return sg[codes.long()], codes


def snap_concat_value(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Values-only :func:`snap_concat`, as a threshold/select chain
    (the reference's form; with duplicate entries the chain and the count
    pick entries of equal value)."""
    sg, tie_hi = _concat_order(grid, x.dtype)
    mids = (sg[1:] + sg[:-1]) * 0.5
    out = sg[0].expand(x.shape).clone()
    for i in range(mids.shape[0]):
        take = (x > mids[i]) | ((x == mids[i]) & tie_hi[i])
        out = torch.where(take, sg[i + 1], out)
    return out
