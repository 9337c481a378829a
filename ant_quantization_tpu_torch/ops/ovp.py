"""Outlier-victim pair (OVP) encoding, the OliVe mechanism.

Counterpart of the reference's ``ops/ovp.py``. After a snap onto the
concatenated normal + outlier grid, every value with |q| > 32 is an
outlier. Values are grouped into aligned pairs (2k, 2k+1) along
``pair_axis``; an outlier takes the encoding space of its pair neighbour
(the victim), which is zeroed. An outlier at the even slot kills the odd
slot; otherwise an outlier at the odd slot kills the even slot, so an
outlier that is itself a victim stays zeroed.
"""

from __future__ import annotations

import torch

__all__ = ["OUTLIER_THRESHOLD", "victim_mask", "apply_ovp"]

OUTLIER_THRESHOLD = 32.0


def victim_mask(outlier_mask: torch.Tensor,
                pair_axis: int = -1) -> torch.Tensor:
    """Boolean mask of the victims of a boolean outlier mask; the length
    along ``pair_axis`` must be even."""
    m = outlier_mask.movedim(pair_axis, -1)
    n = m.shape[-1]
    if n % 2:
        raise ValueError(f"OVP pair axis must be even-length, got {n}")
    mp = m.reshape(*m.shape[:-1], n // 2, 2)
    m_even, m_odd = mp[..., 0], mp[..., 1]
    v_odd = m_even                      # outlier at even kills the odd slot
    v_even = m_odd & ~m_even            # else outlier at odd kills even
    v = torch.stack([v_even, v_odd], dim=-1).reshape(m.shape)
    return v.movedim(-1, pair_axis)


def apply_ovp(q: torch.Tensor, pair_axis: int = -1,
              threshold: float = OUTLIER_THRESHOLD) -> torch.Tensor:
    """Zero the victims of the snapped (integer-domain) tensor ``q``, as
    the reference does: a multiply by the keep mask (so a negative victim
    becomes -0.0)."""
    victims = victim_mask(q.abs() > threshold, pair_axis)
    return q * (~victims).to(q.dtype)
