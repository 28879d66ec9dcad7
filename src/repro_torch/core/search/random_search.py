"""Random sampling — the paper's own experiment method ("we randomly sampled
200 Nvidia Jetson Orin configurations").  A copy of
``repro/core/search/random_search.py``."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.search.base import SearchAlgorithm


class RandomSearch(SearchAlgorithm):
    def __init__(self, space, seed: int = 0, dedupe: bool = True,
                 max_tries: int = 50):
        super().__init__(space, seed)
        self.dedupe = dedupe
        self.max_tries = max_tries
        self._seen = set()

    def ask(self, n: int) -> List[Dict]:
        out = []
        for _ in range(n):
            cfg = self.space.sample(self.rng)
            if self.dedupe:
                for _ in range(self.max_tries):
                    if self._key(cfg) not in self._seen:
                        break
                    cfg = self.space.sample(self.rng)
                self._seen.add(self._key(cfg))
            out.append(cfg)
        return out
