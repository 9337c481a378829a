"""Statistics over a whole window: every sample counts, none is a median
of pieces."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The p-th percentile (0-100) of all the samples, linear between
    the order statistics (numpy's default); None without samples."""
    xs = sorted(values)
    if not xs:
        return None
    r = (len(xs) - 1) * p / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def rate(count: float, seconds: float) -> Optional[float]:
    """A count over the whole window's seconds."""
    return count / seconds if seconds > 0 else None
