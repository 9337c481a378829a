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

``snap_value_search`` and ``snap_concat_value_search`` give the same
values as ``snap_value`` and ``snap_concat_value`` by a binary search of
the midpoints (``torch.bucketize``) and one gather, a few passes over x
where the select chains take two per midpoint; the fake-quants of
calibration use them. ``snap_uniform`` is the O(1) snap of the uniform
(> 6-bit int) grids and ``snap_bruteforce`` the oracle of the tests.
A NaN input is outside their contract (a fake-quant's output is NaN
there whatever it snaps to).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["snap_codes", "snap_value", "snap", "snap_concat",
           "snap_concat_value", "snap_value_search",
           "snap_concat_value_search", "snap_uniform", "snap_bruteforce"]


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


def snap_value_search(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """:func:`snap_value` by a binary search: the code is the count of
    midpoints <= x (``bucketize(right=True)``), which is the select
    chain's last taken step, because the midpoints of a sorted grid never
    decrease (duplicate entries included)."""
    g = grid.to(x.dtype)
    mids = (g[1:] + g[:-1]) * 0.5
    return g[torch.bucketize(x.contiguous(), mids, right=True,
                             out_int32=True)]


def snap_concat_value_search(x: torch.Tensor,
                             grid: torch.Tensor) -> torch.Tensor:
    """:func:`snap_concat_value` by a binary search. The select chain
    keeps the last midpoint i it takes: every i with mid_i < x, then
    among the midpoints equal to x (one run of the sorted midpoints,
    [lo, hi)) the last with ``tie_hi``. ``run_tie[i]`` is that last index
    of i's run from i on (-1 if none), found once per grid."""
    sg, tie_hi = _concat_order(grid, x.dtype)
    mids = (sg[1:] + sg[:-1]) * 0.5
    n = mids.shape[0]
    idx = torch.arange(n, device=x.device)
    later = ((mids[None, :] == mids[:, None]) & (idx[None, :] >= idx[:, None])
             & tie_hi[None, :])
    run_tie = torch.where(later, idx[None, :], -1).amax(dim=1).to(torch.int32)
    x = x.contiguous()
    lo = torch.bucketize(x, mids, out_int32=True)              # mid < x
    hi = torch.bucketize(x, mids, right=True, out_int32=True)  # mid <= x
    last = lo - 1
    tied = torch.maximum(last, run_tie[lo.clamp(max=n - 1)])
    return sg[torch.where(hi > lo, tied, last) + 1]


def snap_uniform(x: torch.Tensor, grid: torch.Tensor,
                 size: Optional[int] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Snap onto a uniformly spaced sorted grid in O(1) ops:
    ``codes = clip(floor((x - g0) / step + 0.5), 0, top)``, the midpoint
    rule with ties to the larger value. ``size``: the grid's real entry
    count; None derives it from the grid (storage grids are padded by
    repeating the max entry): ``top = round((g[-1] - g0) / (g[1] - g0))``
    and the step from the endpoints. Values are ``g0 + codes * step``.
    Every constant is a tensor of x's dtype, so the arithmetic is the
    same on every device."""
    g = grid.to(x.dtype)
    g0 = g[0]
    if size is None:
        top = torch.round((g[-1] - g0) / (g[1] - g0))
        gmax = g[-1]
    else:
        top = torch.tensor(float(size - 1), dtype=x.dtype, device=x.device)
        gmax = g[size - 1]
    step = (gmax - g0) / top
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    codes = torch.clamp(torch.floor((x - g0) / step + half),
                        min=torch.zeros_like(top), max=top)
    return g0 + codes * step, codes.to(torch.int32)


def snap_bruteforce(x: torch.Tensor,
                    grid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """O(N G) oracle with the CUDA scan's order: the grid in its given
    order (unsorted allowed), the update on ``dist <= best``, so the last
    of the nearest entries wins. Returns (values, int32 codes)."""
    g = grid.to(x.dtype)
    d = (x[..., None] - g).abs()
    # the last index among the minima is the first of the reversed scan
    codes = (g.shape[0] - 1) - torch.argmin(d.flip(-1), dim=-1)
    return g[codes], codes.to(torch.int32)
