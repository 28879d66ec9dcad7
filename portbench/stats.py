"""The arithmetic of the metrics: percentiles and intervals."""
from __future__ import annotations

import numpy as np


def percentile(values, q: float):
    """The q-th percentile (0-100) of ``values``, linear between ranks; None if empty."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle gaps (start, end) of [lo, hi] that no interval covers, longest first."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])
