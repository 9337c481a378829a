"""Grid snap: map every element to its nearest entry of a sorted grid.

Counterpart of the reference's ``ops/snap.py`` (``snap_codes``,
``snap_value``). The rule is a compare against the G-1 midpoints
``(g[i] + g[i+1]) * 0.5``, taken in the input's dtype: ``x >= mid`` moves
to the larger entry, so exact midpoint ties go to the larger value (the
original CUDA extension's ``<=`` scan). ``searchsorted`` is not used: its
tie rule differs.
"""

from __future__ import annotations

import torch

__all__ = ["snap_codes", "snap_value"]


def _mids(grid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    g = grid.to(dtype)
    return (g[1:] + g[:-1]) * 0.5


def snap_codes(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Index (int32) into ``grid`` (sorted ascending) of each element's
    nearest entry, ties going to the larger entry."""
    mids = _mids(grid, x.dtype)
    idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(mids.shape[0]):
        idx += (x >= mids[i]).to(torch.int32)
    return idx


def snap_value(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Snapped values (in x's dtype), same midpoint rule as
    :func:`snap_codes`."""
    g = grid.to(x.dtype)
    mids = (g[1:] + g[:-1]) * 0.5
    out = g[0].expand(x.shape).clone()
    for i in range(mids.shape[0]):
        out = torch.where(x >= mids[i], g[i + 1], out)
    return out
