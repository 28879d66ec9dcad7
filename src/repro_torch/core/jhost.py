"""JHost — the host-side orchestrator (paper §III, Algorithm 1).

Port of ``repro/core/jhost.py``.  JHost is a thin facade over
``repro_torch.core.scheduler.DispatchScheduler``, which holds all dispatch,
requeue, deadline and client-freeing state; JHost's loop moves data
between the search algorithm, the transport, the scheduler and the
ResultStore:

  * batch dispatch — ``batch_size``-config chunks per free client
    (``dispatch="eager"``), or every client's queue kept two chunks deep
    (``dispatch="pipelined"``);
  * adaptive chunk sizing — ``chunk_budget_ms`` replaces the static
    batch_size with a per-client EWMA-targeted wall-time budget per chunk;
  * straggler mitigation — every chunk carries a deadline; on timeout the
    late client is quarantined and surviving configs are re-queued (up to
    ``max_retries`` per config); with ``speculate_frac`` a nearly-expired
    chunk is mirrored to a second client first (first answer wins);
  * compile-affinity placement — with ``affinity`` + ``fingerprint_fn``
    (normally ``JConfig.cache_key``) same-fingerprint chunks go back to the
    client that holds the build;
  * result saving — every result lands in a ResultStore (CSV streaming);
  * async search overlap — a ``SearchDriver`` (it exposes
    ``poll_ask``/``note_demand``) is topped up from precomputed asks and
    only blocks the loop when nothing is in flight.

The reference's durable sweeps (``checkpoint_dir``, ``resume``) and fleet
artifact store (``fleet_store``) belong to ROADMAP slice 6: ``explore``
keeps their parameters and raises ``NotImplementedError`` for them.

Scalar mode (``batch_size=None``, eager) is the chunk-of-1 case and keeps
the one-testConfig-per-message wire format.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.jconfig import TestConfig
from repro_torch.core.results import ResultRecord, ResultStore
from repro_torch.core.scheduler import DispatchScheduler
from repro_torch.core.search.base import SearchAlgorithm
from repro_torch.core.transport import (CLIENT_HELLO, HostTransport,
                                        is_membership_msg)

SLICE_6 = ("durable sweeps and the fleet artifact store are not ported yet "
           "(ROADMAP slice 6: durability, elasticity, service)")


def handle_membership(msg: dict, sched: DispatchScheduler,
                      transport: HostTransport, who: str = "jhost") -> None:
    """Fold one HELLO/GOODBYE frame into scheduler + transport state."""
    cid = msg.get("client_id")
    if cid is None:
        return
    if msg.get("cmd") == CLIENT_HELLO:
        if cid not in transport.client_ids():
            try:
                transport.add_client(cid, msg.get("endpoint"))
            except NotImplementedError:
                print(f"# {who}: client {cid} said hello but "
                      f"{type(transport).__name__} cannot add "
                      f"push paths — results accepted, no dispatches")
        slot = sched.add_client(cid, resident_fps=msg.get("resident_fps"))
        ci = msg.get("cache_info")
        if isinstance(ci, dict):
            slot.shadow.resync(ci.get("currsize"), ci.get("maxsize"))
    else:                                   # CLIENT_GOODBYE
        drain = bool(msg.get("drain", True))
        sched.remove_client(cid, drain=drain)
        if not drain:
            # a hard leave frees the push path now; a draining client
            # still needs it until its queued chunks complete
            try:
                transport.remove_client(cid)
            except NotImplementedError:
                pass


class JHost:
    def __init__(self, transport: HostTransport,
                 store: Optional[ResultStore] = None,
                 timeout_s: float = 600.0,
                 max_retries: int = 2,
                 poll_s: float = 0.05):
        self.transport = transport
        self.store = store if store is not None else ResultStore()
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.poll_s = poll_s
        self.quarantined: set = set()
        self.scheduler: Optional[DispatchScheduler] = None

    # -- Algorithm 1, JHOST procedure -----------------------------------------
    def explore(self, search: SearchAlgorithm, arch: str, shape: str,
                n_samples: int,
                objectives: Sequence[str] = ("time_s", "power_w"),
                progress: bool = False,
                batch_size: Optional[int] = None,
                dispatch: str = "eager",
                chunk_budget_ms: Optional[float] = None,
                affinity: str = "off",
                fingerprint_fn=None,
                client_cache_size: int = 64,
                speculate_frac: Optional[float] = None,
                speculate_slow_mult: Optional[float] = None,
                pipeline_depth: Optional[int] = None,
                fleet_store=None,
                scheduler: Optional[DispatchScheduler] = None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 25,
                checkpoint_keep: int = 3,
                resume: bool = False) -> ResultStore:
        if fleet_store is not None or checkpoint_dir is not None or resume:
            raise NotImplementedError(SLICE_6)
        sched = scheduler if scheduler is not None else DispatchScheduler(
            self.transport.client_ids(), policy=dispatch,
            timeout_s=self.timeout_s, max_retries=self.max_retries,
            batch_size=batch_size,
            chunk_budget_s=(None if chunk_budget_ms is None
                            else chunk_budget_ms / 1e3),
            affinity=affinity, fingerprint_fn=fingerprint_fn,
            client_cache_size=client_cache_size,
            speculate_frac=speculate_frac,
            speculate_slow_mult=speculate_slow_mult,
            pipeline_depth=pipeline_depth)
        self.scheduler = sched
        self.quarantined = sched.quarantined   # shared set, stays live
        sched.wire_stats_fn = getattr(self.transport, "wire_summary", None)
        # an async SearchDriver exposes poll_ask/note_demand: the host tops
        # the pipeline up from its precomputed buffer without blocking on
        # search math while results are in flight
        poll_ask = getattr(search, "poll_ask", None)
        note_demand = getattr(search, "note_demand", None)
        # shadow-aware pools: with a fingerprint_fn the searcher learns which
        # sw fingerprints are resident in the fleet's cache shadows (no-ops
        # for searchers without the hooks)
        note_residency = None
        if fingerprint_fn is not None:
            set_fp_fn = getattr(search, "set_sw_fingerprint_fn", None)
            if set_fp_fn is not None:
                set_fp_fn(lambda knobs, _a=arch, _s=shape:
                          fingerprint_fn(TestConfig(-1, _a, _s, knobs)))
            note_residency = getattr(search, "note_residency", None)
        self._explore_loop(search, sched, arch, shape, n_samples, objectives,
                           progress, poll_ask, note_demand, note_residency)
        return self.store

    def _explore_loop(self, search, sched, arch, shape, n_samples,
                      objectives, progress, poll_ask, note_demand,
                      note_residency) -> int:
        id_next = issued = completed = 0
        while completed < n_samples:
            # top up the pending queue with fresh asks, then fill pipelines
            want = min(n_samples - issued, sched.want())
            if want > 0:
                if note_residency is not None:
                    note_residency(sched.resident_fingerprints())
                if poll_ask is not None:
                    if note_demand is not None:
                        note_demand(min(n_samples - issued,
                                        sched.want(lookahead=1)))
                    cfgs = poll_ask(want, need=not sched.busy())
                else:
                    cfgs = search.ask(want)
                for knobs in cfgs or ():
                    sched.submit(TestConfig(id_next, arch, shape, knobs))
                    id_next += 1
                    issued += 1
            for client, tcs in sched.next_dispatches():
                self.transport.push_many(client, [tc.to_wire() for tc in tcs])

            msgs = self.transport.pull_many(self.poll_s)
            mems = [m for m in msgs if is_membership_msg(m)]
            if mems:
                # fleet elasticity: HELLO/GOODBYE frames ride the result
                # stream and never reach the scheduler's result path
                msgs = [m for m in msgs if not is_membership_msg(m)]
                for m in mems:
                    handle_membership(m, sched, self.transport)
            if msgs:
                sched.note_results()   # frame boundary: coalescing detection
            for msg in msgs:
                tc = sched.on_result(msg)
                if tc is None:          # duplicate answer: bookkeeping only
                    continue
                if "knobs" not in msg:  # slim batch result: rehydrate echo
                    msg["knobs"], msg["arch"], msg["shape"] = \
                        tc.knobs, tc.arch, tc.shape
                rec = ResultRecord.from_wire(msg)
                self.store.add(rec)
                completed += 1
                if rec.status == "ok":
                    search.tell(rec.knobs, np.asarray(
                        [rec.metrics[k] for k in objectives], float))
                if progress and completed % 10 == 0:
                    s = sched.stats()
                    wire = ""
                    if "wire_out_mb" in s:
                        wire = (f", wire {s['wire_out_mb']:.2f}/"
                                f"{s['wire_in_mb']:.2f} MB "
                                f"{s.get('codec', '?')}")
                    print(f"[jhost] {completed}/{n_samples} "
                          f"(inflight={s['inflight']:.0f}, "
                          f"pending={s['pending']:.0f}, "
                          f"chunk~{s['mean_chunk']:.1f}{wire})")

            # straggler sweep: requeue survivors, record terminal timeouts
            for tc, client in sched.expire():
                self.store.add(ResultRecord(
                    config_id=tc.config_id, arch=arch, shape=shape,
                    knobs=tc.knobs, metrics={}, status="timeout",
                    client_id=client))
                completed += 1

            if completed < n_samples and sched.stuck():
                stats = sched.stats()
                self.store.close()
                raise RuntimeError(
                    f"all clients quarantined; exploration stuck at "
                    f"{completed}/{n_samples} (scheduler stats: {stats})")
        return completed

    def stop_clients(self) -> None:
        failed = []
        for c in self.transport.client_ids():
            try:
                self.transport.push(c, {"cmd": "stop"})
            except Exception as e:
                failed.append((c, e))
        for c, e in failed:
            # a push that cannot even be queued means the board is hung or
            # its path is gone — surface it instead of silently leaking it
            print(f"# jhost: client {c} failed to take stop: {e!r}")
