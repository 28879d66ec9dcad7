"""Pareto utilities (from ``repro/core/results.py``).

Only the nondominated mask is ported so far; ``ResultRecord`` and
``ResultStore`` come with the explore loop.
"""
from __future__ import annotations

import numpy as np


def nondominated_mask(points: np.ndarray) -> np.ndarray:
    """points (N, M), minimisation.  True where no other point dominates.

    One ``(B, N, M)`` broadcast per ≤512-row block (blocked so huge stores
    don't allocate an N² intermediate) instead of a Python loop over rows —
    this sits on the per-ask EHVI hot path.
    """
    points = np.asarray(points)
    n = len(points)
    mask = np.ones(n, bool)
    for lo in range(0, n, 512):
        blk = points[lo:lo + 512]                       # (B, M)
        le = np.all(points[:, None, :] <= blk[None, :, :], axis=2)
        lt = np.any(points[:, None, :] < blk[None, :, :], axis=2)
        mask[lo:lo + 512] = ~np.any(le & lt, axis=0)
    return mask


def _nondominated_mask_loop(points: np.ndarray) -> np.ndarray:
    """Reference per-row implementation (kept for equivalence tests)."""
    n = len(points)
    mask = np.ones(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominates = np.all(points <= points[i], axis=1) & np.any(points < points[i], axis=1)
        if np.any(dominates):
            mask[i] = False
    return mask
