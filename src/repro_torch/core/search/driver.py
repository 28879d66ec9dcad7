"""SearchDriver — overlap search math with client-side evaluation.

A copy of ``repro/core/search/driver.py``.

After the batched/pipelined host work, the transport side of the DSE loop
sustains tens of thousands of evals/sec — but a model-based searcher
(BayesOpt/PAL) runs its GP algebra *inline* in ``JHost.explore``, so every
ask stalls the whole fleet.  ``SearchDriver`` wraps any ``SearchAlgorithm``
and moves that math off the host's critical path:

* ``mode="sync"`` — pure pass-through.  Every ``ask``/``tell`` runs inline
  on the caller's thread; picks are bit-identical to the bare algorithm
  (this is the equivalence baseline, and the safe default for cheap
  searchers like random/grid where a worker thread buys nothing).
* ``mode="async"`` — a background worker precomputes asks into a buffer
  while clients evaluate the current chunks.  ``tell``s are buffered and
  folded into the algorithm at ask boundaries — stale-tolerant by design: a
  precomputed pick may lag the newest few observations, exactly like a
  pipelined chunk that was dispatched before its predecessor's results
  landed.  ``max_stale_tells`` bounds that tolerance: a buffered pick that
  would lag the model by more than that many folded tells is discarded and
  recomputed (counted in ``stats()["stale_dropped"]``) instead of being
  handed out.  The host's side of the contract is ``poll_ask``: non-blocking
  whenever evaluation work is in flight (``DispatchScheduler.busy()``), and
  blocking only when the loop cannot otherwise make progress.  The
  scheduler's ``want(lookahead=...)`` is the matching backpressure signal —
  it sizes the precompute buffer so a freed client slot tops up from
  already-computed picks instead of waiting on GP math.

The wrapped algorithm is only ever touched by one thread at a time: in sync
mode the caller's, in async mode the worker's (the host thread just moves
dicts in and out of the buffers under the driver lock).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.search.base import SearchAlgorithm

MODES = ("sync", "async")


class SearchDriver:
    """Plug-in wrapper: speaks ask/tell plus the host's non-blocking hooks."""

    def __init__(self, algo: SearchAlgorithm, mode: str = "async",
                 round_size: int = 32,
                 max_stale_tells: Optional[int] = None,
                 name: Optional[str] = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if max_stale_tells is not None and max_stale_tells < 0:
            raise ValueError(f"max_stale_tells must be >= 0, "
                             f"got {max_stale_tells!r}")
        self.algo = algo
        self.mode = mode
        # optional label (the owning tenant under ExploreService); surfaced
        # in stats() so interleaved drivers stay tellable apart in logs
        self.name = name
        self.round_size = max(int(round_size), 1)
        # staleness bound: a buffered pick was computed against the model
        # state at some tell count; once the model has folded more than
        # ``max_stale_tells`` newer observations, the stale buffer is
        # discarded and recomputed instead of being handed out (None keeps
        # the unbounded stale-tolerant behaviour)
        self.max_stale_tells = max_stale_tells
        # buffer entries are (pick, fold-count when the pick was computed),
        # so staleness is judged per pick, not per buffer generation
        self._buf: Deque[Tuple[Dict, int]] = deque()
        self._tells: Deque[Tuple[Dict, np.ndarray]] = deque()
        self._target = 0
        self._closing = False
        self._paused = False       # quiesce flag for state_dict/load_state
        self._computing = False    # worker is inside an unlocked ask round
        self._err: Optional[BaseException] = None
        self._cond = threading.Condition()
        self.n_rounds = 0          # worker ask rounds computed
        self.n_precomputed = 0     # configs ever placed in the buffer
        self.n_tells_folded = 0    # buffered tells folded into the algo
        self.n_stale_dropped = 0   # precomputed picks discarded as too stale
        # residency updates are buffered like tells: the worker owns the
        # algorithm, so the host thread never touches it directly (latest
        # update wins — residency is a snapshot, not a log)
        self._pending_fp_fn: Optional[Tuple] = None
        self._pending_residency: Optional[frozenset] = None
        self._worker: Optional[threading.Thread] = None
        if mode == "async":
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="search-driver")
            self._worker.start()

    # -- SearchAlgorithm protocol ---------------------------------------------
    def ask(self, n: int) -> List[Dict]:
        """Blocking ask: exactly n picks (drop-in for a bare algorithm)."""
        if self.mode == "sync":
            return self.algo.ask(n)
        out: List[Dict] = []
        while len(out) < n:
            out.extend(self.poll_ask(n - len(out), need=True))
        return out

    def tell(self, knobs: Dict, y: np.ndarray) -> None:
        if self.mode == "sync":
            self.algo.tell(knobs, y)
            return
        with self._cond:
            self._tells.append((dict(knobs), np.asarray(y, float)))
            self._cond.notify_all()

    # -- host-facing async hooks ----------------------------------------------
    def poll_ask(self, n: int, need: bool = False) -> List[Dict]:
        """Up to n precomputed picks, possibly none.

        Blocks only when ``need`` is set (the host has nothing in flight and
        cannot make progress without fresh configs); otherwise returns
        whatever the worker has buffered and lets the host go back to
        pulling results while the next ask computes.
        """
        if self.mode == "sync":
            return self.algo.ask(n)
        with self._cond:
            self._target = max(self._target, n)
            self._cond.notify_all()            # demand may wake the worker
            while need and not self._buf and self._err is None \
                    and not self._closing:
                self._cond.wait()
            if self._err is not None:
                raise RuntimeError("search worker died") from self._err
            out = [self._buf.popleft()[0]
                   for _ in range(min(n, len(self._buf)))]
            if out:
                self._cond.notify_all()        # buffer has room: refill
            return out

    def set_sw_fingerprint_fn(self, fn) -> None:
        """Forward the knobs→sw-fingerprint map to the wrapped algorithm
        (inline in sync mode; via the worker in async mode)."""
        if self.mode == "sync":
            if hasattr(self.algo, "set_sw_fingerprint_fn"):
                self.algo.set_sw_fingerprint_fn(fn)
            return
        with self._cond:
            self._pending_fp_fn = (fn,)
            self._cond.notify_all()

    def note_residency(self, fps) -> None:
        """Forward the fleet's resident-fingerprint snapshot (latest wins)."""
        if self.mode == "sync":
            if hasattr(self.algo, "note_residency"):
                self.algo.note_residency(fps)
            return
        with self._cond:
            self._pending_residency = frozenset(fps)
            self._cond.notify_all()

    def note_demand(self, n: int) -> None:
        """Backpressure from the scheduler: keep ~n picks precomputed."""
        if self.mode == "sync":
            return
        with self._cond:
            self._target = max(int(n), 1)
            self._cond.notify_all()

    def ready(self) -> int:
        """Precomputed picks available without blocking."""
        if self.mode == "sync":
            return 0
        with self._cond:
            return len(self._buf)

    # -- lifecycle ------------------------------------------------------------
    def close(self, timeout_s: float = 10.0) -> None:
        if self._worker is None:
            return
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout_s)

    def __enter__(self) -> "SearchDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, float]:
        with self._cond:
            out = {"mode": self.mode, "buffered": len(self._buf),
                   "pending_tells": len(self._tells),
                   "rounds": self.n_rounds,
                   "precomputed": self.n_precomputed,
                   "tells_folded": self.n_tells_folded,
                   "stale_dropped": self.n_stale_dropped}
            if self.name is not None:
                out["name"] = self.name
            return out

    # -- durable state ---------------------------------------------------------
    def _quiesce(self) -> None:
        """Pause the worker and wait out any in-flight ask round.

        Must be called with the condition held; leaves ``_paused`` set — the
        caller owns the algorithm until it clears the flag and notifies."""
        self._paused = True
        self._cond.notify_all()
        while self._computing:
            self._cond.wait()

    def state_dict(self) -> Dict:
        """Snapshot the wrapped algorithm plus the driver's buffers.

        Async mode quiesces the worker first so the algorithm state, the
        not-yet-folded tells, and the precomputed-but-undispatched picks are
        captured as one consistent cut.  The buffered picks are saved (their
        flat keys already live in the algorithm's seen-set, so dropping them
        would leak those configs forever), but the resumed fold boundaries
        still depend on worker timing — async resume is correct, not
        bit-identical (see ``durable.restore_sweep``).
        """
        if self.mode == "sync":
            return {"driver": True, "mode": "sync",
                    "algo": self.algo.state_dict(), "tells": [],
                    "buffered": []}
        with self._cond:
            self._quiesce()
            try:
                return {"driver": True, "mode": self.mode,
                        "algo": self.algo.state_dict(),
                        "tells": [(dict(k), np.asarray(y, float))
                                  for k, y in self._tells],
                        "buffered": [dict(p) for p, _ in self._buf]}
            finally:
                self._paused = False
                self._cond.notify_all()

    def load_state(self, state: Dict) -> None:
        if state.get("driver"):
            algo_state = state["algo"]
            tells = state.get("tells", [])
            buffered = state.get("buffered", [])
        else:                       # bare-algorithm snapshot: still loadable
            algo_state, tells, buffered = state, [], []
        if self.mode == "sync":
            self.algo.load_state(algo_state)
            for k, y in tells:
                self.algo.tell(dict(k), np.asarray(y, float))
            return
        with self._cond:
            self._quiesce()
            try:
                self.algo.load_state(algo_state)
                self._tells.clear()
                self._tells.extend((dict(k), np.asarray(y, float))
                                   for k, y in tells)
                self._buf.clear()
                self._buf.extend((dict(p), self.n_tells_folded)
                                 for p in buffered)
            finally:
                self._paused = False
                self._cond.notify_all()

    # -- worker ---------------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._closing and (
                        self._paused
                        or (not self._tells
                            and len(self._buf) >= max(self._target, 1))):
                    self._cond.wait()
                if self._closing:
                    return
                self._computing = True     # unlocked ask round in flight
                tells = list(self._tells)
                self._tells.clear()
                fp_fn, self._pending_fp_fn = self._pending_fp_fn, None
                residency, self._pending_residency = \
                    self._pending_residency, None
                if self.max_stale_tells is not None and self._buf:
                    # discard (oldest-first: bases are monotone) only the
                    # picks that will lag the model by more than the bound
                    # once this round folds; this round recomputes them
                    # against fresh state
                    folded = self.n_tells_folded + len(tells)
                    while self._buf and (folded - self._buf[0][1]
                                         > self.max_stale_tells):
                        self._buf.popleft()
                        self.n_stale_dropped += 1
                want = max(self._target, 1) - len(self._buf)
                # empty buffer means the host may be blocked on us: compute
                # a small round first to unblock it, then get ahead with
                # full rounds while it dispatches
                cap = self.round_size if self._buf else max(
                    min(8, self.round_size), 1)
            try:
                # fold buffered observations at the ask boundary, then
                # precompute the next round while clients keep evaluating
                if fp_fn is not None and \
                        hasattr(self.algo, "set_sw_fingerprint_fn"):
                    self.algo.set_sw_fingerprint_fn(fp_fn[0])
                if residency is not None and \
                        hasattr(self.algo, "note_residency"):
                    self.algo.note_residency(residency)
                for knobs, y in tells:
                    self.algo.tell(knobs, y)
                picks = self.algo.ask(min(want, cap)) if want > 0 else []
            except BaseException as e:        # surface in the host thread
                with self._cond:
                    self._computing = False
                    self._err = e
                    self._cond.notify_all()
                return
            with self._cond:
                self._computing = False
                self.n_tells_folded += len(tells)
                if picks:
                    self.n_rounds += 1
                    self.n_precomputed += len(picks)
                    self._buf.extend((p, self.n_tells_folded) for p in picks)
                self._cond.notify_all()
