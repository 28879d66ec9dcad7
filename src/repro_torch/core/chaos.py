"""Deterministic fault injection for the host↔client wire.

A copy of ``repro/core/chaos.py``.

``ChaosTransport`` wraps any ``HostTransport`` and perturbs the frame
stream under a seeded RNG, so every failure scenario the durability layer
claims to survive is a *repeatable* test, not a flake:

* ``drop_p`` / ``dup_p`` / ``delay_s`` — outbound config frames are
  dropped, duplicated, or delivered late with fixed probabilities drawn
  from ``np.random.default_rng(seed)``.  A dropped chunk exercises the
  deadline/quarantine/retry path; a duplicated one exercises the
  first-answer-wins inflight dedup; delays exercise pipelining.
* ``kill_client(cid)`` / ``kill_client_at=(cid, n)`` — a killed client's
  frames are silently discarded in both directions from that point on
  (exactly what a powered-off board looks like), either immediately or
  scripted after the n-th delivered result.
* ``crash_at_results=n`` + ``crash_fn`` — the host "crashes" (default
  ``os._exit(42)``, a kill -9 equivalent: no atexit, no finally blocks)
  the moment the n-th result message is about to be delivered.  Paired
  with ``--resume`` this is the acceptance harness: die mid-sweep,
  restart, finish with zero duplicate evaluations and a bit-identical
  Pareto front.

Inbound *result* drops are intentionally not offered: a real network can
drop a result frame, but the client-side TCP/queue layers this repo ships
cannot un-send one — and the recovery path it would exercise (deadline →
retry) is already covered by outbound drops.  Every delegated method
(``client_ids``, ``wire_summary``, membership, ``close``) passes straight
through, so a ChaosTransport composes with any inner transport, loopback
or ZMQ.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.transport import HostTransport, is_artifact_msg, \
    is_membership_msg


def _default_crash() -> None:
    # os._exit skips atexit/finally — the closest in-process stand-in for
    # kill -9: no checkpoint flush, no store close, no transport goodbye
    os._exit(42)


class ChaosTransport(HostTransport):
    """Seeded fault-injecting wrapper around a host transport."""

    def __init__(self, inner: HostTransport, *,
                 seed: int = 0,
                 drop_p: float = 0.0,
                 dup_p: float = 0.0,
                 delay_s: float = 0.0,
                 crash_at_results: Optional[int] = None,
                 crash_fn: Callable[[], None] = _default_crash,
                 kill_client_at: Optional[Tuple[int, int]] = None):
        self.inner = inner
        self.rng = np.random.default_rng(seed)
        self.drop_p = float(drop_p)
        self.dup_p = float(dup_p)
        self.delay_s = float(delay_s)
        self.crash_at_results = crash_at_results
        self.crash_fn = crash_fn
        self.kill_client_at = kill_client_at
        self._killed: Set[int] = set()
        self.n_results_seen = 0     # delivered result messages (post-chaos)
        self.n_dropped = 0
        self.n_duplicated = 0
        self.n_delayed = 0
        self.n_killed_frames = 0    # frames discarded for killed clients

    # -- scripted faults -------------------------------------------------------
    def kill_client(self, client_id: int) -> None:
        """From now on the client neither receives nor answers anything."""
        self._killed.add(client_id)

    # -- outbound (host → client) ----------------------------------------------
    def push(self, client_id: int, msg: dict) -> None:
        if client_id in self._killed:
            self.n_killed_frames += 1
            return
        if self.drop_p and self.rng.random() < self.drop_p:
            self.n_dropped += 1
            return
        if self.delay_s and self.rng.random() < 0.5:
            # a blocking sleep *is* the delay a one-queue-per-client wire
            # shows: everything behind this frame arrives late too
            self.n_delayed += 1
            time.sleep(self.delay_s)
        self.inner.push(client_id, msg)
        if self.dup_p and self.rng.random() < self.dup_p:
            self.n_duplicated += 1
            self.inner.push(client_id, msg)

    def push_many(self, client_id: int, msgs: List[dict]) -> None:
        if client_id in self._killed:
            self.n_killed_frames += 1
            return
        HostTransport.push_many(self, client_id, msgs)

    # -- inbound (client → host) -----------------------------------------------
    def pull(self, timeout_s: float) -> Optional[dict]:
        return self.inner.pull(timeout_s)

    def pull_many(self, timeout_s: float) -> List[dict]:
        msgs = self.inner.pull_many(timeout_s)
        out: List[dict] = []
        for m in msgs:
            cid = m.get("client_id") if isinstance(m, dict) else None
            if cid in self._killed:
                self.n_killed_frames += 1
                continue
            if isinstance(m, dict) and "config_id" in m \
                    and not is_artifact_msg(m) and not is_membership_msg(m):
                # the crash fires BEFORE the batch is handed to the host:
                # the whole frame is lost, exactly like a kill -9 between
                # the socket recv and the store write — those configs'
                # re-runs on resume are by design
                if self.crash_at_results is not None \
                        and self.n_results_seen >= self.crash_at_results:
                    self.crash_at_results = None   # fire once
                    self.crash_fn()
                    return []          # non-exiting crash_fn (tests)
                self.n_results_seen += 1
                if self.kill_client_at is not None \
                        and self.n_results_seen >= self.kill_client_at[1]:
                    self.kill_client(self.kill_client_at[0])
                    self.kill_client_at = None
            out.append(m)
        return out

    # -- pass-through ----------------------------------------------------------
    def client_ids(self) -> List[int]:
        return [c for c in self.inner.client_ids() if c not in self._killed]

    def add_client(self, client_id: int,
                   endpoint: Optional[str] = None) -> None:
        self.inner.add_client(client_id, endpoint)

    def remove_client(self, client_id: int) -> None:
        self.inner.remove_client(client_id)

    def wire_summary(self):
        return self.inner.wire_summary()

    def close(self) -> None:
        self.inner.close()

    def stats(self) -> dict:
        return {"results_seen": self.n_results_seen,
                "dropped": self.n_dropped, "duplicated": self.n_duplicated,
                "delayed": self.n_delayed,
                "killed_frames": self.n_killed_frames,
                "killed_clients": sorted(self._killed)}
