"""JHost — the host-side orchestrator (paper §III, Algorithm 1).

A copy of ``repro/core/jhost.py``.

Interfaces a user-defined search algorithm with N clients.  Since the
scheduler refactor, JHost is a thin facade: all dispatch, requeue, deadline,
and client-freeing state lives in ``repro_torch.core.scheduler.DispatchScheduler``
(explicit ``Chunk``/``ClientSlot`` state machines, testable without threads
or transports); JHost's loop just moves data between the search algorithm,
the transport, the scheduler, and the ResultStore:

  * batch dispatch — the scheduler asks for ``batch_size``-config chunks per
    free client (``dispatch="eager"``, the batched barrier), or keeps every
    client's queue two chunks deep (``dispatch="pipelined"`` double-
    buffering, so clients never idle between result push and next pull);
  * adaptive chunk sizing — with ``chunk_budget_ms`` the static batch_size
    is replaced by a per-client EWMA-targeted wall-time budget per chunk;
  * straggler mitigation / fault tolerance — every chunk carries a deadline;
    on timeout the late client is quarantined and surviving configs are
    re-queued (up to ``max_retries`` per config), waiting in the pending
    queue if no client is free at sweep time; with ``speculate_frac`` a
    nearly-expired chunk is mirrored to a second client first (first answer
    wins) so a straggler costs one speculation, not a full deadline;
  * compile-affinity placement — with ``affinity`` + ``fingerprint_fn``
    (normally ``JConfig.cache_key``) the scheduler tracks which sw
    fingerprints each client holds compiled and routes same-fingerprint
    chunks back to that client (see ``repro_torch.core.scheduler``);
  * fleet artifact store — with a ``fleet_store``
    (``repro_torch.core.fleet.FleetArtifactStore``) the loop intercepts
    ``artifact_*`` frames from the result stream and feeds them to the
    store, which serves/relays compiled artifacts between clients and
    enforces exactly-one-compile-per-fingerprint fleet-wide; the
    scheduler additionally treats fleet-resident fingerprints as free
    riders when homing compile groups;
  * result saving — every result lands in a ResultStore (CSV streaming);
  * async search overlap — when ``search`` is a ``SearchDriver`` (it
    exposes ``poll_ask``/``note_demand``), the loop feeds the scheduler's
    backpressure (``want(lookahead=1)``) to the driver and tops the
    pipeline up from precomputed asks without blocking on GP math; it only
    blocks on the search when nothing is in flight (``sched.busy()``).

Scalar mode (``batch_size=None``, eager) is the degenerate chunk-of-1 case
and keeps the original one-testConfig-per-message wire format.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.durable import ExplorationCheckpoint, restore_sweep
from repro_torch.core.fleet import FleetArtifactStore
from repro_torch.core.jconfig import TestConfig
from repro_torch.core.results import ResultRecord, ResultStore
from repro_torch.core.scheduler import DispatchScheduler
from repro_torch.core.search.base import SearchAlgorithm
from repro_torch.core.transport import (CLIENT_HELLO, HostTransport,
                                  is_artifact_msg, is_membership_msg)


def handle_membership(msg: dict, sched: DispatchScheduler,
                      transport: HostTransport, who: str = "jhost") -> None:
    """Fold one HELLO/GOODBYE frame into scheduler + transport state.

    Shared by the single-sweep ``JHost`` loop and the multi-tenant
    ``ExploreService`` loop — fleet elasticity is tenant-agnostic.
    """
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
        # restore_sweep's stats of the last resumed sweep (None until one)
        self.resume_info: Optional[dict] = None

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
                fleet_store: Optional[FleetArtifactStore] = None,
                scheduler: Optional[DispatchScheduler] = None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every: int = 25,
                checkpoint_keep: int = 3,
                resume: bool = False) -> ResultStore:
        # fleet residency consult for affinity dispatch: a fingerprint the
        # fleet store can serve is a fetch, not a compile, wherever it lands
        fleet_resident_fn = None
        if fleet_store is not None and fingerprint_fn is not None:
            fleet_resident_fn = \
                lambda fp, _fs=fleet_store: _fs.resident_fp(repr(fp))
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
            pipeline_depth=pipeline_depth,
            fleet_resident_fn=fleet_resident_fn)
        self.scheduler = sched
        self.quarantined = sched.quarantined   # shared set, stays live
        sched.wire_stats_fn = getattr(self.transport, "wire_summary", None)
        id_next = 0          # next config id to issue (monotone, checkpointed)
        issued = completed = 0
        # an async SearchDriver exposes poll_ask/note_demand: the host tops
        # the pipeline up from its precomputed buffer without blocking on
        # search math while results are in flight, and only blocks when the
        # loop cannot otherwise progress
        poll_ask = getattr(search, "poll_ask", None)
        note_demand = getattr(search, "note_demand", None)
        # shadow-aware pools: with a fingerprint_fn the searcher learns which
        # sw fingerprints are resident in the fleet's cache shadows and
        # biases its candidate pools toward them (no-ops for searchers
        # without the hooks)
        note_residency = None
        if fingerprint_fn is not None:
            set_fp_fn = getattr(search, "set_sw_fingerprint_fn", None)
            if set_fp_fn is not None:
                set_fp_fn(lambda knobs, _a=arch, _s=shape:
                          fingerprint_fn(TestConfig(-1, _a, _s, knobs)))
            note_residency = getattr(search, "note_residency", None)

        # -- durability: checkpoint + write-ahead event log (core.durable) ----
        ckpt: Optional[ExplorationCheckpoint] = None
        outstanding: Dict[int, dict] = {}   # asked-but-uncompleted: id→knobs
        if checkpoint_dir is not None:
            ckpt = ExplorationCheckpoint(checkpoint_dir, keep=checkpoint_keep)
            if resume:
                n_prior = self.store.resume_from_csv()
                info = restore_sweep(ckpt, search, self.store, objectives)
                # a copy: the loop below drains ``outstanding`` as it runs
                self.resume_info = dict(info, outstanding=dict(info["outstanding"]))
                outstanding = info["outstanding"]
                id_next = info["next_id"]
                completed = len(self.store.records)
                issued = completed + len(outstanding)
                mism = (f", {info['n_ask_mismatch']} ask replays diverged "
                        f"(logged knobs kept)"
                        if info["n_ask_mismatch"] else "")
                print(f"# resume: {n_prior} completed rows re-adopted, "
                      f"{info['n_events']} events replayed, "
                      f"{info['n_late_tells']} late tells, "
                      f"{len(outstanding)} in-flight configs "
                      f"re-submitted{mism}")
                for cid in sorted(outstanding):   # original ids, not re-asked
                    sched.submit(TestConfig(cid, arch, shape,
                                            outstanding[cid]))
            ckpt.open_log()
        last_snap = completed

        try:
            completed = self._explore_loop(
                search, sched, arch, shape, n_samples, objectives, progress,
                fleet_store, ckpt, checkpoint_every, outstanding,
                id_next, issued, completed, last_snap,
                poll_ask, note_demand, note_residency)
        finally:
            if ckpt is not None:
                ckpt.close()
        return self.store

    def _explore_loop(self, search, sched, arch, shape, n_samples,
                      objectives, progress, fleet_store, ckpt,
                      checkpoint_every, outstanding, id_next, issued,
                      completed, last_snap, poll_ask, note_demand,
                      note_residency) -> int:
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
                if cfgs:
                    tcs_new = []
                    for knobs in cfgs:
                        tcs_new.append(TestConfig(id_next, arch, shape,
                                                  knobs))
                        id_next += 1
                    if ckpt is not None:
                        # write-ahead: the ask reaches the log BEFORE any
                        # dispatch, so a crash can never lose which ids were
                        # issued for which knobs
                        ckpt.log_ask([tc.config_id for tc in tcs_new],
                                     [tc.knobs for tc in tcs_new])
                    for tc in tcs_new:
                        outstanding[tc.config_id] = tc.knobs
                        sched.submit(tc)
                        issued += 1
            for client, tcs in sched.next_dispatches():
                self.transport.push_many(client, [tc.to_wire() for tc in tcs])

            msgs = self.transport.pull_many(self.poll_s)
            mems = [m for m in msgs if is_membership_msg(m)]
            if mems:
                # fleet elasticity: HELLO/GOODBYE frames ride the result
                # stream like ARTIFACT_* and never reach the scheduler's
                # result path
                msgs = [m for m in msgs if not is_membership_msg(m)]
                for m in mems:
                    self._on_membership(m, sched)
            if fleet_store is not None:
                # artifact traffic rides the same sockets as results but is
                # the store's business, not the scheduler's
                arts = [m for m in msgs if is_artifact_msg(m)]
                if arts:
                    msgs = [m for m in msgs if not is_artifact_msg(m)]
                    for m in arts:
                        fleet_store.on_message(m, self.transport.push)
                fleet_store.tick(self.transport.push)
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
                outstanding.pop(rec.config_id, None)
                if rec.status == "ok":
                    y = np.asarray([rec.metrics[k] for k in objectives],
                                   float)
                    search.tell(rec.knobs, y)
                    if ckpt is not None:
                        # logged AFTER the CSV row + fold: a crash in the
                        # window between them is the "late tell" case
                        # restore_sweep reconciles from the CSV
                        ckpt.log_tell(rec.config_id, rec.knobs, y)
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
                outstanding.pop(tc.config_id, None)

            if ckpt is not None and completed - last_snap >= checkpoint_every:
                last_snap = completed
                ckpt.save({
                    "version": 1,
                    "event_pos": ckpt.log_pos(),
                    "next_id": id_next,
                    "outstanding": list(outstanding.items()),
                    "search_state": (search.state_dict()
                                     if hasattr(search, "state_dict")
                                     else None),
                    "meta": {"arch": arch, "shape": shape,
                             "n_samples": n_samples, "completed": completed,
                             "objectives": list(objectives)},
                })

            if completed < n_samples and sched.stuck():
                stats = sched.stats()
                # flush the CSV first so the dead sweep stays resumable
                self.store.close()
                raise RuntimeError(
                    f"all clients quarantined; exploration stuck at "
                    f"{completed}/{n_samples} (scheduler stats: {stats})")
        return completed

    # -- dynamic membership ----------------------------------------------------
    def _on_membership(self, msg: dict, sched: DispatchScheduler) -> None:
        handle_membership(msg, sched, self.transport, who="jhost")

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
