"""NSGA-II (Deb et al., PPSN 2000 — the paper's reference [7]).

A copy of ``repro/core/search/nsga2.py``.

Generational evolutionary multi-objective search adapted to the ask/tell
protocol: ``ask`` hands out unevaluated individuals of the current
generation; once the whole generation is told, parents+children undergo fast
non-dominated sorting + crowding-distance selection and a new child
population is bred by binary tournament, uniform crossover and ±1 ordinal
mutation (the knob ladders are ordered, so step mutation is meaningful).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.search.base import SearchAlgorithm


def fast_nondominated_sort(ys: np.ndarray) -> List[np.ndarray]:
    """Non-domination fronts via one ``(N, N, K)`` broadcast.

    The full pairwise domination matrix is computed in one shot; front
    peeling is then pure counter arithmetic (subtract each peeled front's
    row-sums) instead of the O(N²) Python double loop.  Front membership and
    order match the loop reference (``_fast_nondominated_sort_loop``).
    """
    ys = np.asarray(ys, float)
    n = len(ys)
    if n == 0:
        return []
    le = np.all(ys[:, None, :] <= ys[None, :, :], axis=2)
    lt = np.any(ys[:, None, :] < ys[None, :, :], axis=2)
    dominates = le & lt                       # [i, j]: i dominates j
    dom_count = dominates.sum(axis=0)
    assigned = np.zeros(n, bool)
    fronts = []
    current = np.where(dom_count == 0)[0]
    while current.size:
        fronts.append(current)
        assigned[current] = True
        dom_count = dom_count - dominates[current].sum(axis=0)
        current = np.where((dom_count == 0) & ~assigned)[0]
    return fronts


def _fast_nondominated_sort_loop(ys: np.ndarray) -> List[np.ndarray]:
    """Reference O(N²) Python implementation (kept for equivalence tests)."""
    n = len(ys)
    dominated_by = [[] for _ in range(n)]
    dom_count = np.zeros(n, int)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if np.all(ys[i] <= ys[j]) and np.any(ys[i] < ys[j]):
                dominated_by[i].append(j)
            elif np.all(ys[j] <= ys[i]) and np.any(ys[j] < ys[i]):
                dom_count[i] += 1
    fronts = []
    current = np.where(dom_count == 0)[0]
    while len(current):
        fronts.append(current)
        nxt = []
        for i in current:
            for j in dominated_by[i]:
                dom_count[j] -= 1
                if dom_count[j] == 0:
                    nxt.append(j)
        current = np.asarray(sorted(set(nxt)), int)
    return fronts


def crowding_distance(ys: np.ndarray) -> np.ndarray:
    n, m = ys.shape
    dist = np.zeros(n)
    if n <= 2:
        return np.full(n, np.inf)
    for k in range(m):
        order = np.argsort(ys[:, k])
        span = ys[order[-1], k] - ys[order[0], k]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        dist[order[1:-1]] += (ys[order[2:], k] - ys[order[:-2], k]) / span
    return dist


class NSGA2(SearchAlgorithm):
    def __init__(self, space, seed: int = 0, pop_size: int = 24,
                 p_crossover: float = 0.9, p_mutate: float = 0.25):
        super().__init__(space, seed)
        self.pop_size = pop_size
        self.p_crossover = p_crossover
        self.p_mutate = p_mutate
        self._pending: List[Dict] = [space.sample(self.rng) for _ in range(pop_size)]
        self._gen_x: List[Dict] = []
        self._gen_y: List[np.ndarray] = []
        self._parents_x: List[Dict] = []
        self._parents_y: List[np.ndarray] = []

    # -- ask/tell ------------------------------------------------------------
    def ask(self, n: int) -> List[Dict]:
        out = []
        while len(out) < n:
            if not self._pending:
                self._pending = [self.space.mutate(self.space.sample(self.rng), self.rng)
                                 for _ in range(max(1, n - len(out)))]
            out.append(self._pending.pop(0))
        return out

    def tell(self, knobs: Dict, y: np.ndarray) -> None:
        super().tell(knobs, y)
        self._gen_x.append(dict(knobs))
        self._gen_y.append(np.asarray(y, float))
        if len(self._gen_x) >= self.pop_size:
            self._evolve()

    # -- internals ------------------------------------------------------------
    def _select(self, xs: List[Dict], ys: np.ndarray) -> List[int]:
        """Environmental selection to pop_size via fronts + crowding."""
        chosen: List[int] = []
        for front in fast_nondominated_sort(ys):
            if len(chosen) + len(front) <= self.pop_size:
                chosen.extend(front.tolist())
            else:
                cd = crowding_distance(ys[front])
                order = front[np.argsort(-cd)]
                chosen.extend(order[: self.pop_size - len(chosen)].tolist())
                break
        return chosen

    def _tournament(self, ys: np.ndarray, ranks: np.ndarray, cd: np.ndarray) -> int:
        i, j = self.rng.integers(len(ys)), self.rng.integers(len(ys))
        if ranks[i] != ranks[j]:
            return i if ranks[i] < ranks[j] else j
        return i if cd[i] >= cd[j] else j

    def _evolve(self) -> None:
        xs = self._parents_x + self._gen_x
        ys_list = self._parents_y + self._gen_y
        ys = np.stack(ys_list)
        idx = self._select(xs, ys)
        self._parents_x = [xs[i] for i in idx]
        self._parents_y = [ys_list[i] for i in idx]
        self._gen_x, self._gen_y = [], []

        pys = np.stack(self._parents_y)
        fronts = fast_nondominated_sort(pys)
        ranks = np.zeros(len(pys), int)
        for r, f in enumerate(fronts):
            ranks[f] = r
        cd = np.zeros(len(pys))
        for f in fronts:
            cd[f] = crowding_distance(pys[f])

        children: List[Dict] = []
        seen = set()
        while len(children) < self.pop_size:
            a = self._parents_x[self._tournament(pys, ranks, cd)]
            b = self._parents_x[self._tournament(pys, ranks, cd)]
            if self.rng.random() < self.p_crossover:
                child = {k.name: (a if self.rng.random() < 0.5 else b)[k.name]
                         for k in self.space.knobs}
            else:
                child = dict(a)
            child = self.space.mutate(child, self.rng, self.p_mutate)
            key = self._key(child)
            if key in seen:
                child = self.space.sample(self.rng)
                key = self._key(child)
            seen.add(key)
            children.append(child)
        self._pending = children
