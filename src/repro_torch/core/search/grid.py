"""Strided grid sweep — exhaustive enumeration order shuffled by a linear
congruential stride so truncated budgets still cover the space uniformly.
A copy of ``repro/core/search/grid.py``."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.search.base import SearchAlgorithm


class GridSearch(SearchAlgorithm):
    def __init__(self, space, seed: int = 0):
        super().__init__(space, seed)
        self._sizes = [len(k.values) for k in space.knobs]
        self._n = int(np.prod(self._sizes))
        # coprime stride => a permutation of the flat index space
        self._stride = self._pick_stride()
        self._offset = int(self.rng.integers(self._n))
        self._i = 0

    def _pick_stride(self) -> int:
        cand = max(3, int(self._n * 0.6180339887))
        while np.gcd(cand, self._n) != 1:
            cand += 1
        return cand

    def _unflatten(self, flat: int) -> Dict:
        cfg = {}
        for k, s in zip(self.space.knobs, self._sizes):
            cfg[k.name] = k.values[flat % s]
            flat //= s
        return cfg

    def ask(self, n: int) -> List[Dict]:
        out = []
        for _ in range(n):
            if self._i >= self._n:
                self._i = 0  # wrap (finite space exhausted)
            flat = (self._offset + self._i * self._stride) % self._n
            out.append(self._unflatten(flat))
            self._i += 1
        return out
