"""Window statistics: rates over the whole window, tails over all jobs."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by nearest rank: the smallest value
    with at least q% of the values at or below it.  A failed job is given
    as math.inf and counts as slower than every finished one."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def rate(units: float, seconds: float) -> float:
    """All the work over all the time."""
    return units / seconds
