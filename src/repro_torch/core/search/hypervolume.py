"""Exact hypervolume indicators (minimisation, reference point dominated by
all fronts).  2-D: sweep; 3-D: slicing over the third objective."""
from __future__ import annotations

import numpy as np

from repro_torch.core.results import nondominated_mask


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    pts = np.asarray(points, float)
    ref = np.asarray(ref, float)
    pts = pts[np.all(pts < ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    pts = pts[nondominated_mask(pts)]
    pts = pts[np.argsort(pts[:, 0])]
    hv, prev_y = 0.0, ref[1]
    for x, y in pts:
        hv += (ref[0] - x) * (prev_y - y)
        prev_y = y
    return float(hv)


def hypervolume_3d(points: np.ndarray, ref: np.ndarray) -> float:
    pts = np.asarray(points, float)
    pts = pts[np.all(pts < ref, axis=1)]
    if len(pts) == 0:
        return 0.0
    pts = pts[nondominated_mask(pts)]
    zs = np.concatenate([np.unique(pts[:, 2]), ref[2:3]])  # ascending slab edges
    hv = 0.0
    for lo, hi in zip(zs[:-1], zs[1:]):
        active = pts[pts[:, 2] <= lo][:, :2]
        hv += hypervolume_2d(active, ref[:2]) * (hi - lo)
    return float(hv)


def hypervolume(points: np.ndarray, ref: np.ndarray) -> float:
    m = np.asarray(ref).shape[0]
    if m == 2:
        return hypervolume_2d(points, ref)
    if m == 3:
        return hypervolume_3d(points, ref)
    raise NotImplementedError(f"hypervolume for M={m}")
