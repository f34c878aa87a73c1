"""Order statistics over all samples of a run."""

from __future__ import annotations

import math


def percentile(values, q: float):
    """The ``q``-th percentile of every value, by linear interpolation
    between the two nearest ranks (numpy's default); None if empty."""
    vals = sorted(values)
    if not vals:
        return None
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


def merged(intervals) -> list:
    """(start, end) intervals merged where they overlap, in order."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out
