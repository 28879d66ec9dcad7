"""Multi-tenant exploration service — many sweeps, one fleet.

A copy of ``repro/core/tenancy.py``.

``JHost.explore`` runs one sweep then exits, so a fleet serving several
users spends most of its wall clock idle between back-to-back runs.
``ExploreService`` is the long-lived daemon that turns that idle time into
throughput: it owns ONE shared ``DispatchScheduler`` + transport + optional
``FleetArtifactStore`` and multiplexes K tenants over them, each tenant
with its own search algorithm (or async ``SearchDriver``, any gp_mode),
``ResultStore``, objectives, and optional checkpoint directory.

How the multiplexing works
--------------------------
* **Fair share** — every tenant is registered with the scheduler's
  deficit-weighted round-robin layer (``weight`` / ``priority`` /
  ``max_inflight``; see ``repro_torch.core.scheduler``).  Each dispatched chunk
  draws from exactly one tenant's queue, so one tenant's quarantine storm
  or giant space cannot starve another, while affinity, speculation, and
  the fleet artifact store stay fleet-global — tenants share one
  artifact-cache namespace (keyed on ``JConfig.identity()``) and warm each
  other's compiles for free.
* **Id spaces** — the shared scheduler needs globally unique config_ids,
  but each tenant's results (and its checkpoint WAL) must look exactly
  like a solo run's: the service issues a fleet-global id per config and
  maps it back to the tenant-local id (0..n-1 in ask order) before a
  record is stored, told to the search, logged, or streamed.  Per-tenant
  metrics are therefore bit-identical to the same sweep run alone.
* **Wire tagging** — outbound chunks carry a ``"tenant"`` sidecar key on
  each config dict and results may echo it back.  Old clients tolerate
  the extra key (``TestConfig.from_wire`` reads only its four fields) and
  old hosts ignore the echo (``ResultRecord.from_wire`` filters unknown
  keys), so mixed fleets keep working.
* **Streaming** — ``subscribe(tenant)`` yields each ``ResultRecord`` as it
  lands, ending when the sweep completes or is cancelled; the
  ``CONTROL_SUBMIT/STATUS/CANCEL`` verbs (``repro_torch.core.transport``) expose
  the same operations over the wire / stdin for ``launch.serve_explore``.
* **Durability** — a tenant submitted with ``checkpoint_dir`` (or under a
  service-wide ``checkpoint_root``, namespaced per tenant by
  ``durable.tenant_checkpoint_dir``) gets the full snapshot + WAL
  treatment, logged in tenant-local ids so ``resume`` works whether the
  sweep is later re-run solo or under the service.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.core.durable import (ExplorationCheckpoint, restore_sweep,
                                tenant_checkpoint_dir)
from repro_torch.core.fleet import FleetArtifactStore
from repro_torch.core.jconfig import TestConfig
from repro_torch.core.jhost import handle_membership
from repro_torch.core.results import ResultRecord, ResultStore
from repro_torch.core.scheduler import DispatchScheduler
from repro_torch.core.transport import (CONTROL_CANCEL, CONTROL_STATUS,
                                  CONTROL_SUBMIT, HostTransport,
                                  is_artifact_msg, is_control_msg,
                                  is_membership_msg)

_DONE = object()          # subscriber sentinel: the sweep is finished


class TenantSweep:
    """One tenant's sweep as the service tracks it (internal)."""

    __slots__ = ("name", "search", "arch", "shape", "n_samples", "objectives",
                 "store", "ckpt", "checkpoint_every", "fingerprint_fn",
                 "issued", "completed", "last_snap", "local_next",
                 "outstanding", "subscribers", "state",
                 "poll_ask", "note_demand", "note_residency")

    def __init__(self, name: str, search, arch: str, shape: str,
                 n_samples: int, objectives: Sequence[str],
                 store: ResultStore,
                 ckpt: Optional[ExplorationCheckpoint],
                 checkpoint_every: int,
                 fingerprint_fn: Optional[Callable]):
        self.name = name
        self.search = search
        self.arch = arch
        self.shape = shape
        self.n_samples = n_samples
        self.objectives = tuple(objectives)
        self.store = store
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.fingerprint_fn = fingerprint_fn
        self.issued = 0
        self.completed = 0
        self.last_snap = 0
        self.local_next = 0              # tenant-local config-id counter
        self.outstanding: Dict[int, dict] = {}   # local id -> knobs
        self.subscribers: List[queue.Queue] = []
        self.state = "running"           # running | done | cancelled
        # async SearchDriver hooks (None for plain algorithms)
        self.poll_ask = getattr(search, "poll_ask", None)
        self.note_demand = getattr(search, "note_demand", None)
        self.note_residency = getattr(search, "note_residency", None)

    def active(self) -> bool:
        return self.state == "running"


class ExploreService:
    """Long-lived multi-tenant exploration daemon over one shared fleet.

    Construct it with a host transport (and the usual scheduler knobs),
    ``submit_sweep()`` any number of tenants — before or during ``run()``
    — and drive it with ``run()`` (blocking until every registered sweep
    finishes) or ``run(stop_when_idle=False)`` + ``stop()`` for daemon
    use.  ``subscribe()``, ``status()``, and ``cancel()`` are thread-safe
    and may be called from other threads while the loop runs.
    """

    def __init__(self, transport: HostTransport, *,
                 timeout_s: float = 600.0,
                 max_retries: int = 2,
                 poll_s: float = 0.05,
                 batch_size: Optional[int] = None,
                 dispatch: str = "eager",
                 chunk_budget_ms: Optional[float] = None,
                 affinity: str = "off",
                 client_cache_size: int = 64,
                 speculate_frac: Optional[float] = None,
                 speculate_slow_mult: Optional[float] = None,
                 pipeline_depth: Optional[int] = None,
                 fleet_store: Optional[FleetArtifactStore] = None,
                 checkpoint_root: Optional[str] = None,
                 checkpoint_every: int = 25,
                 progress: bool = False):
        self.transport = transport
        self.poll_s = poll_s
        self.fleet_store = fleet_store
        self.checkpoint_root = checkpoint_root
        self.checkpoint_every = checkpoint_every
        self.progress = progress
        fleet_resident_fn = None
        if fleet_store is not None:
            fleet_resident_fn = \
                lambda fp, _fs=fleet_store: _fs.resident_fp(repr(fp))
        # one scheduler for every tenant: the service-level fingerprint fn
        # routes to the owning tenant's (spaces differ, namespace is shared)
        self.scheduler = DispatchScheduler(
            transport.client_ids(), policy=dispatch, timeout_s=timeout_s,
            max_retries=max_retries, batch_size=batch_size,
            chunk_budget_s=(None if chunk_budget_ms is None
                            else chunk_budget_ms / 1e3),
            affinity=affinity, fingerprint_fn=self._tc_fingerprint,
            client_cache_size=client_cache_size,
            speculate_frac=speculate_frac,
            speculate_slow_mult=speculate_slow_mult,
            pipeline_depth=pipeline_depth,
            fleet_resident_fn=fleet_resident_fn)
        self.scheduler.wire_stats_fn = getattr(transport, "wire_summary",
                                               None)
        self.quarantined = self.scheduler.quarantined   # shared live set
        if fleet_store is not None:
            # per-tenant served/assigned attribution: a client asking the
            # store for an artifact is evaluating its head chunk — that
            # chunk's tenant owns the hit or the assigned compile
            fleet_store.tenant_fn = self._tenant_of_client
        self._sweeps: Dict[str, TenantSweep] = {}
        self._by_gid: Dict[int, tuple] = {}   # global id -> (sweep, local id)
        self._gid_next = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._wake = threading.Event()        # a submit can unblock the loop
        # control-plane spec factory: maps a CONTROL_SUBMIT spec dict to
        # submit_sweep kwargs (launch.serve_explore installs one; without
        # it, wire SUBMIT is refused — STATUS/CANCEL always work)
        self.sweep_factory: Optional[Callable[[dict], dict]] = None

    # -- tenant lifecycle ------------------------------------------------------
    def submit_sweep(self, name: str, search, arch: str, shape: str,
                     n_samples: int,
                     objectives: Sequence[str] = ("time_s", "power_w"),
                     store: Optional[ResultStore] = None,
                     csv_path: Optional[str] = None,
                     weight: float = 1.0,
                     priority: int = 0,
                     max_inflight: Optional[int] = None,
                     fingerprint_fn: Optional[Callable] = None,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: Optional[int] = None,
                     checkpoint_keep: int = 3,
                     resume: bool = False,
                     knob_names: Optional[Sequence[str]] = None) -> TenantSweep:
        """Register a tenant sweep; safe before or during ``run()``."""
        with self._lock:
            if name in self._sweeps and self._sweeps[name].active():
                raise ValueError(f"tenant {name!r} already has a running "
                                 f"sweep (cancel it first)")
            if store is None:
                store = ResultStore(csv_path=csv_path,
                                    knob_names=knob_names or (),
                                    metric_names=tuple(objectives))
            if checkpoint_dir is None and self.checkpoint_root is not None:
                checkpoint_dir = tenant_checkpoint_dir(self.checkpoint_root,
                                                       name)
            ckpt = None
            if checkpoint_dir is not None:
                ckpt = ExplorationCheckpoint(checkpoint_dir,
                                             keep=checkpoint_keep)
            sweep = TenantSweep(name, search, arch, shape, n_samples,
                                objectives, store, ckpt,
                                checkpoint_every or self.checkpoint_every,
                                fingerprint_fn)
            self.scheduler.add_tenant(name, weight=weight, priority=priority,
                                      max_inflight=max_inflight)
            if ckpt is not None:
                if resume:
                    n_prior = store.resume_from_csv()
                    info = restore_sweep(ckpt, search, store, objectives)
                    sweep.outstanding = info["outstanding"]
                    sweep.local_next = info["next_id"]
                    sweep.completed = len(store.records)
                    sweep.issued = sweep.completed + len(sweep.outstanding)
                    sweep.last_snap = sweep.completed
                    print(f"# tenancy[{name}]: resume re-adopted {n_prior} "
                          f"rows, replayed {info['n_events']} events, "
                          f"re-submitting {len(sweep.outstanding)} in-flight")
                    for lid in sorted(sweep.outstanding):
                        self._submit_one(sweep, lid, sweep.outstanding[lid])
                ckpt.open_log()
            self._sweeps[name] = sweep
            self._wake.set()
            return sweep

    def cancel(self, name: str) -> Dict[str, int]:
        """Drop a tenant's queued work, orphan its in-flight configs, and
        end its subscribers' streams.  In-flight evaluations finish on the
        clients but their answers ride the duplicate path — no result is
        recorded for them."""
        with self._lock:
            sweep = self._sweeps.get(name)
            if sweep is None:
                raise KeyError(f"unknown tenant {name!r}")
            n_queued, n_orphaned = self.scheduler.cancel_tenant(name)
            for gid in [g for g, (sw, _) in self._by_gid.items()
                        if sw is sweep]:
                del self._by_gid[gid]
            if sweep.active():
                sweep.state = "cancelled"
                self._finalize(sweep)
            return {"queued_dropped": n_queued,
                    "inflight_orphaned": n_orphaned}

    def status(self, name: Optional[str] = None) -> Dict[str, Any]:
        """Progress snapshot: one tenant's, or every tenant's keyed by name."""
        with self._lock:
            if name is not None:
                sweep = self._sweeps.get(name)
                if sweep is None:
                    raise KeyError(f"unknown tenant {name!r}")
                return self._status_one(sweep)
            return {n: self._status_one(s) for n, s in self._sweeps.items()}

    def _status_one(self, sweep: TenantSweep) -> Dict[str, Any]:
        t = self.scheduler.tenants.get(sweep.name)
        out = {"state": sweep.state, "issued": sweep.issued,
               "completed": sweep.completed, "n_samples": sweep.n_samples,
               "outstanding": len(sweep.outstanding)}
        if t is not None:
            out.update(queued=len(t.queue), inflight=t.inflight,
                       weight=t.weight, priority=t.priority,
                       deficit=round(t.deficit, 6), cost_ewma=t.cost_ewma)
        return out

    def subscribe(self, name: str,
                  timeout_s: Optional[float] = None
                  ) -> Iterator[ResultRecord]:
        """Stream a tenant's ResultRecords as they land.

        Yields every record recorded *after* the call; the generator ends
        when the sweep completes or is cancelled.  ``timeout_s`` bounds the
        wait for each next record (raises ``queue.Empty`` on expiry).
        """
        with self._lock:
            sweep = self._sweeps.get(name)
            if sweep is None:
                raise KeyError(f"unknown tenant {name!r}")
            if not sweep.active():
                return
            q: queue.Queue = queue.Queue()
            sweep.subscribers.append(q)
        while True:
            item = q.get(timeout=timeout_s)
            if item is _DONE:
                return
            yield item

    def stop(self) -> None:
        """Ask a ``run(stop_when_idle=False)`` loop to exit."""
        self._stop.set()
        self._wake.set()

    # -- the shared dispatch loop ----------------------------------------------
    def run(self, stop_when_idle: bool = True,
            idle_poll_s: float = 0.25) -> None:
        """Drive every registered sweep over the shared fleet.

        ``stop_when_idle=True`` (batch use): returns once all registered
        sweeps are done.  ``stop_when_idle=False`` (daemon use): keeps
        waiting for new ``submit_sweep``/control traffic until ``stop()``.
        """
        sched = self.scheduler
        while not self._stop.is_set():
            with self._lock:
                active = [s for s in self._sweeps.values() if s.active()]
                if active:
                    self._intake(active)
                    for client, tcs in sched.next_dispatches():
                        tenant = sched.tenant_of(tcs[0].config_id)
                        self.transport.push_many(
                            client, [dict(tc.to_wire(), tenant=tenant)
                                     for tc in tcs])
            msgs = self.transport.pull_many(self.poll_s if active
                                            else idle_poll_s)
            with self._lock:
                self._drain(msgs)
                self._checkpoint_and_finish()
                active = [s for s in self._sweeps.values() if s.active()]
                if active and sched.stuck():
                    for s in active:
                        s.store.close()      # keep every sweep resumable
                    raise RuntimeError(
                        f"all clients quarantined; service stuck with "
                        f"tenants {[s.name for s in active]} unfinished "
                        f"(scheduler stats: {sched.stats()})")
            if not active:
                if stop_when_idle:
                    return
                self._wake.wait(idle_poll_s)
                self._wake.clear()

    def _intake(self, active: List[TenantSweep]) -> None:
        """Top every active tenant's queue up to its fair share of the
        fleet's open capacity with fresh asks from its own search."""
        sched = self.scheduler
        for sweep in active:
            remaining = sweep.n_samples - sweep.issued
            if remaining <= 0:
                continue
            want = min(remaining, sched.want_for(sweep.name))
            if want <= 0:
                continue
            if sweep.note_residency is not None:
                sweep.note_residency(sched.resident_fingerprints())
            if sweep.poll_ask is not None:
                if sweep.note_demand is not None:
                    sweep.note_demand(min(remaining,
                                          sched.want_for(sweep.name,
                                                         lookahead=1)))
                # need= only when the whole fleet would otherwise idle
                cfgs = sweep.poll_ask(want, need=not sched.busy())
            else:
                cfgs = sweep.search.ask(want)
            if not cfgs:
                continue
            lids = []
            for knobs in cfgs:
                lids.append((sweep.local_next, knobs))
                sweep.local_next += 1
            if sweep.ckpt is not None:
                # write-ahead in LOCAL ids: the WAL replays identically
                # whether the sweep resumes solo or under the service
                sweep.ckpt.log_ask([lid for lid, _ in lids],
                                   [knobs for _, knobs in lids])
            for lid, knobs in lids:
                sweep.outstanding[lid] = knobs
                self._submit_one(sweep, lid, knobs)
                sweep.issued += 1

    def _submit_one(self, sweep: TenantSweep, lid: int, knobs: dict) -> None:
        gid = self._gid_next
        self._gid_next += 1
        tc = TestConfig(gid, sweep.arch, sweep.shape, knobs)
        self._by_gid[gid] = (sweep, lid)
        self.scheduler.submit(tc, tenant=sweep.name)

    def _tc_fingerprint(self, tc: TestConfig):
        """Scheduler fingerprint hook: routed to the owning tenant's fn.

        Tenants whose spaces share a ``JConfig.identity()`` produce equal
        fingerprints for equal sw knobs, so affinity and the fleet store
        treat their compiles as one namespace — cross-tenant warm-up."""
        entry = self._by_gid.get(tc.config_id)
        if entry is None:
            return None
        sweep = entry[0]
        return (sweep.fingerprint_fn(tc)
                if sweep.fingerprint_fn is not None else None)

    def _drain(self, msgs: List[dict]) -> None:
        sched = self.scheduler
        mems = [m for m in msgs if is_membership_msg(m)]
        if mems:
            msgs = [m for m in msgs if not is_membership_msg(m)]
            for m in mems:
                self._on_membership(m)
        ctrls = [m for m in msgs if is_control_msg(m)]
        if ctrls:
            msgs = [m for m in msgs if not is_control_msg(m)]
            for m in ctrls:
                self._on_control(m)
        if self.fleet_store is not None:
            arts = [m for m in msgs if is_artifact_msg(m)]
            if arts:
                msgs = [m for m in msgs if not is_artifact_msg(m)]
                for m in arts:
                    self.fleet_store.on_message(m, self.transport.push)
            self.fleet_store.tick(self.transport.push)
        if msgs:
            sched.note_results()       # frame boundary (coalescing detection)
        for msg in msgs:
            tc = sched.on_result(msg)
            if tc is None:
                continue               # duplicate / orphaned: bookkeeping only
            entry = self._by_gid.pop(tc.config_id, None)
            if entry is None:
                continue               # cancelled while the answer was in flight
            sweep, lid = entry
            if "knobs" not in msg:     # slim batch result: rehydrate echo
                msg["knobs"], msg["arch"], msg["shape"] = \
                    tc.knobs, tc.arch, tc.shape
            msg["config_id"] = lid     # back to the tenant-local id space
            rec = ResultRecord.from_wire(msg)
            self._record(sweep, rec)

        # straggler sweep: requeue survivors, record terminal timeouts
        for tc, client in sched.expire():
            entry = self._by_gid.pop(tc.config_id, None)
            if entry is None:
                continue
            sweep, lid = entry
            self._record(sweep, ResultRecord(
                config_id=lid, arch=tc.arch, shape=tc.shape, knobs=tc.knobs,
                metrics={}, status="timeout", client_id=client))

    def _record(self, sweep: TenantSweep, rec: ResultRecord) -> None:
        sweep.store.add(rec)
        sweep.completed += 1
        sweep.outstanding.pop(rec.config_id, None)
        if rec.status == "ok":
            y = np.asarray([rec.metrics[k] for k in sweep.objectives], float)
            sweep.search.tell(rec.knobs, y)
            if sweep.ckpt is not None:
                sweep.ckpt.log_tell(rec.config_id, rec.knobs, y)
        for q in sweep.subscribers:
            q.put(rec)
        if self.progress and sweep.completed % 10 == 0:
            print(f"[tenancy:{sweep.name}] {sweep.completed}/"
                  f"{sweep.n_samples}")

    def _checkpoint_and_finish(self) -> None:
        for sweep in self._sweeps.values():
            if not sweep.active():
                continue
            if (sweep.ckpt is not None
                    and sweep.completed - sweep.last_snap
                    >= sweep.checkpoint_every):
                sweep.last_snap = sweep.completed
                sweep.ckpt.save({
                    "version": 1,
                    "event_pos": sweep.ckpt.log_pos(),
                    "next_id": sweep.local_next,
                    "outstanding": list(sweep.outstanding.items()),
                    "search_state": (sweep.search.state_dict()
                                     if hasattr(sweep.search, "state_dict")
                                     else None),
                    "meta": {"arch": sweep.arch, "shape": sweep.shape,
                             "n_samples": sweep.n_samples,
                             "completed": sweep.completed,
                             "objectives": list(sweep.objectives)},
                })
            if sweep.completed >= sweep.n_samples:
                sweep.state = "done"
                self._finalize(sweep)

    def _finalize(self, sweep: TenantSweep) -> None:
        if sweep.ckpt is not None:
            sweep.ckpt.close()
            sweep.ckpt = None
        for q in sweep.subscribers:
            q.put(_DONE)
        sweep.subscribers = []

    # -- control plane ---------------------------------------------------------
    def handle_control(self, msg: dict) -> Dict[str, Any]:
        """Execute one SUBMIT/STATUS/CANCEL control message, returning the
        reply dict (also used verbatim by ``launch.serve_explore`` stdin)."""
        cmd = msg.get("cmd")
        try:
            if cmd == CONTROL_STATUS:
                return {"ok": True,
                        "status": self.status(msg.get("tenant"))}
            if cmd == CONTROL_CANCEL:
                return {"ok": True, **self.cancel(msg["tenant"])}
            if cmd == CONTROL_SUBMIT:
                if self.sweep_factory is None:
                    return {"ok": False,
                            "error": "no sweep_factory installed: wire "
                                     "SUBMIT is disabled on this service"}
                kwargs = self.sweep_factory(dict(msg.get("spec") or {}))
                self.submit_sweep(msg["tenant"], **kwargs)
                return {"ok": True, "tenant": msg["tenant"]}
            return {"ok": False, "error": f"unknown control cmd {cmd!r}"}
        except Exception as e:          # control must never kill the loop
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _on_control(self, msg: dict) -> None:
        reply = self.handle_control(msg)
        cid = msg.get("client_id")
        if cid is not None:
            try:
                self.transport.push(cid, dict(reply, cmd="control_reply",
                                              req=msg.get("cmd")))
            except Exception:
                pass                    # a reply path is best-effort

    # -- fleet glue ------------------------------------------------------------
    def _tenant_of_client(self, client_id: int) -> Optional[str]:
        """Which tenant the client is most plausibly working for right now:
        the tenant of its head (running) chunk."""
        slot = self.scheduler.slots.get(client_id)
        if slot is None or not slot.chunks:
            return None
        chunk = self.scheduler.chunks.get(slot.chunks[0])
        return chunk.tenant if chunk is not None else None

    def _on_membership(self, msg: dict) -> None:
        handle_membership(msg, self.scheduler, self.transport, who="tenancy")

    def stop_clients(self) -> None:
        for c in self.transport.client_ids():
            try:
                self.transport.push(c, {"cmd": "stop"})
            except Exception as e:
                print(f"# tenancy: client {c} failed to take stop: {e!r}")

    def stats(self) -> Dict[str, Any]:
        s = self.scheduler.stats()
        if self.fleet_store is not None:
            s.update(self.fleet_store.stats())
        return s
