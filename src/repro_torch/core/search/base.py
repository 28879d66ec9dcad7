"""SearchAlgorithm ABC — the plug-in point for "any search tool" (paper §I).

ask/tell protocol: ``ask(n)`` returns up to n knob dicts to evaluate (batched,
so multi-client JHosts keep every board busy); ``tell(knobs, y)`` reports the
objective vector (always minimised).

Shadow-aware candidate pools: when the fleet scheduler exposes which sw
fingerprints its clients already hold compiled (``note_residency``), a
``residency_bias`` fraction of every ``_fresh_pool`` sample has its sw
columns overwritten with an already-resident sw combination before dedup —
the searcher keeps exploring the hw ladder freely but stops proposing
compile storms.  With no residency reported (the default) the sampling path
and rng stream are bit-identical to before.
"""
from __future__ import annotations

import abc
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.space import DesignSpace, KIND_SW


class SearchAlgorithm(abc.ABC):
    def __init__(self, space: DesignSpace, seed: int = 0,
                 residency_bias: float = 0.5):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.history_x: List[Dict] = []
        self.history_y: List[np.ndarray] = []
        self.residency_bias = residency_bias
        self._sw_fp_fn: Optional[Callable[[Dict], object]] = None
        self._resident_fps: frozenset = frozenset()
        self._fp_to_sw: Dict[object, np.ndarray] = {}

    @abc.abstractmethod
    def ask(self, n: int) -> List[Dict]:
        ...

    def tell(self, knobs: Dict, y: np.ndarray) -> None:
        self.history_x.append(dict(knobs))
        self.history_y.append(np.asarray(y, float))
        if self._sw_fp_fn is not None:
            fp = self._sw_fp_fn(knobs)
            if fp not in self._fp_to_sw:
                self._fp_to_sw[fp] = \
                    self.space.index_encode(knobs)[self._sw_cols()]

    # -- shadow-aware pools --------------------------------------------------
    def set_sw_fingerprint_fn(self, fn: Optional[Callable[[Dict], object]]
                              ) -> None:
        """Install the knobs→sw-fingerprint map (the fleet's cache key), so
        tells can record which sw index combination each fingerprint is."""
        self._sw_fp_fn = fn

    def note_residency(self, fps: Iterable) -> None:
        """Update the set of sw fingerprints currently compiled somewhere in
        the fleet (union of healthy clients' cache shadows)."""
        self._resident_fps = frozenset(fps)

    def _sw_cols(self) -> np.ndarray:
        if not hasattr(self, "_sw_cols_cache"):
            self._sw_cols_cache = np.asarray(
                [i for i, k in enumerate(self.space.knobs)
                 if k.kind == KIND_SW], np.int64)
        return self._sw_cols_cache

    def _resident_sw_combos(self) -> Optional[np.ndarray]:
        """(R, n_sw) index rows for resident fingerprints we have seen told,
        in deterministic (sorted-by-repr) order; None when biasing cannot
        engage."""
        if not self._resident_fps or not self._fp_to_sw:
            return None
        rows = [self._fp_to_sw[fp]
                for fp in sorted(self._resident_fps & self._fp_to_sw.keys(),
                                 key=repr)]
        return np.stack(rows) if rows else None

    # -- durable state -------------------------------------------------------
    _STATE_SKIP = ("space", "rng", "_sw_fp_fn",
                   "_sw_cols_cache", "_flat_mults_cache")

    def state_dict(self) -> Dict:
        """Picklable snapshot of the search state (checkpoint/resume).

        Captures every instance attribute except the design space (the
        resumed run reconstructs it), the installed fingerprint hook (a
        closure — the host re-installs it), and derived caches; the RNG
        travels as its bit_generator state so the resumed stream continues
        bit-exactly.  Subclasses with non-picklable members override
        ``_state_attrs``/``_load_attrs``.
        """
        return {"cls": type(self).__name__,
                "rng": self.rng.bit_generator.state,
                "attrs": self._state_attrs()}

    def _state_attrs(self) -> Dict:
        return {k: v for k, v in self.__dict__.items()
                if k not in self._STATE_SKIP}

    def load_state(self, state: Dict) -> None:
        if state.get("cls") != type(self).__name__:
            print(f"# search: restoring {state.get('cls')!r} state into "
                  f"{type(self).__name__} — resumed picks will not match "
                  f"the crashed run")
        self.rng.bit_generator.state = state["rng"]
        self._load_attrs(state["attrs"])

    def _load_attrs(self, attrs: Dict) -> None:
        for k, v in attrs.items():
            setattr(self, k, v)

    # -- helpers -------------------------------------------------------------
    def _key(self, knobs: Dict) -> tuple:
        return tuple(sorted((k, str(v)) for k, v in knobs.items()))

    def _flat_mults(self) -> np.ndarray:
        if not hasattr(self, "_flat_mults_cache"):
            mults, acc = [], 1
            for k in self.space.knobs:
                mults.append(acc)
                acc *= len(k.values)
            self._flat_mults_cache = np.asarray(mults, np.int64)
        return self._flat_mults_cache

    def _flat_keys(self, idx: np.ndarray) -> np.ndarray:
        """Mixed-radix flat index per row of an ``(n, K)`` index matrix —
        the vectorized dedup key (one int64 dot instead of building a
        sorted tuple of strings per config).  For spaces larger than 2⁶³
        configs the dot wraps; a wraparound collision at worst skips a
        candidate, it never corrupts search state."""
        with np.errstate(over="ignore"):
            return np.asarray(idx, np.int64) @ self._flat_mults()

    def _flat_key(self, knobs: Dict) -> int:
        return int(self._flat_keys(self.space.index_encode(knobs)[None])[0])

    def _fresh_pool(self, size: int, exclude: Optional[Set[int]] = None,
                    max_rounds: int = 50
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Candidate pool of distinct, not-yet-excluded configs, vectorized.

        Replaces the config-at-a-time ``while`` loops the model-based
        searchers used to duplicate: each round samples the whole remainder
        as index arrays in one shot (``DesignSpace.sample_index_batch``),
        drops in-pool duplicates (``np.unique`` on flat keys, first
        occurrence wins so draw order is preserved) and anything in
        ``exclude`` (the caller's already-dispatched flat keys), and tops
        up until full.  Draws from ``self.rng`` — the one stream the scalar
        path used.  Returns ``(idx, coords, flats)``: the ``(P, K)`` value-
        index matrix, the encoded [0, 1] coordinate matrix, and the flat
        dedup key per row — all arrays; callers decode to knob dicts only
        for the handful of configs they actually pick.

        A nearly-exhausted space cannot fill the pool: after ``max_rounds``
        the partial pool is returned instead of spinning forever.

        Residency biasing (see module docstring): when resident sw combos
        are known, the first ``residency_bias`` fraction of each round's
        sample keeps its hw columns but adopts a resident sw combo, before
        dedup — so biased duplicates still collapse and the pool stays
        distinct.  The extra rng draws happen only when biasing engages.
        """
        exclude = exclude if exclude is not None else set()
        combos = self._resident_sw_combos()
        sw_cols = self._sw_cols() if combos is not None else None
        have: Set[int] = set()
        picked_idx: List[np.ndarray] = []
        n_picked = 0
        for _ in range(max_rounds):
            need = size - n_picked
            if need <= 0:
                break
            # mild oversampling keeps the round count low once duplicates
            # against `exclude` become common late in a run
            idx = self.space.sample_index_batch(self.rng, need + (need >> 1) + 4)
            if combos is not None and len(sw_cols):
                nb = int(len(idx) * self.residency_bias)
                if nb:
                    pick = self.rng.integers(0, len(combos), nb)
                    idx[:nb][:, sw_cols] = combos[pick]
            flats = self._flat_keys(idx)
            _, first = np.unique(flats, return_index=True)
            take = []
            for i in np.sort(first):                 # preserve draw order
                if n_picked + len(take) >= size:
                    break
                f = int(flats[i])
                if f in have or f in exclude:
                    continue
                have.add(f)
                take.append(i)
            if take:
                picked_idx.append(idx[np.asarray(take)])
                n_picked += len(take)
        k = len(self.space.knobs)
        idx = (np.vstack(picked_idx) if picked_idx
               else np.zeros((0, k), np.int64))
        return idx, self.space.encode_index_batch(idx), self._flat_keys(idx)

    def observed_points(self) -> np.ndarray:
        return (np.stack([self.space.encode(x) for x in self.history_x])
                if self.history_x else np.zeros((0, len(self.space.knobs))))

    def observed_values(self) -> np.ndarray:
        return (np.stack(self.history_y)
                if self.history_y else np.zeros((0, 0)))
