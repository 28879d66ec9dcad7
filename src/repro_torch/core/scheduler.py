"""Event-driven dispatch scheduler — the host-side orchestration core.

A copy of ``repro/core/scheduler.py``.

``JHost.explore`` used to be one monolithic loop owning dispatch, requeue,
deadline, and client-freeing state; this module extracts that state into an
explicitly-testable ``DispatchScheduler`` built from two small state
machines:

* ``Chunk``      — a dispatched group of testConfigs: which client owns it,
  the deadline by which that client must answer it, and the config_ids the
  owner has not answered *itself* yet (a late straggler answering some of a
  chunk's configs records their results but does not free the owner early).
* ``ClientSlot`` — per-client pipeline state: the FIFO of chunk_ids queued
  on that client, an EWMA of observed per-config wall time, quarantine, and
  a ``CacheShadow`` of the sw fingerprints believed resident in that
  client's artifact LRU.

Dispatch policies
-----------------
``eager``     — depth-1: a client receives its next chunk only after fully
  answering its current one (the batched barrier; ``batch_size=None``
  with this policy is the seed's scalar protocol).
``pipelined`` — depth-N buffering (default 2): the scheduler keeps every
  healthy client's config queue ``pipeline_depth`` chunks deep, so the next
  chunk is already sitting in the client's transport queue when it finishes
  the current one — the client never idles between its result push and next
  pull.  Depth 2 is the classic double-buffer; deeper pipelines hide very
  high-latency links (one chunk in flight per link round-trip).  Per-chunk
  deadlines stack (a queued chunk's clock starts where its predecessor's
  budget ends — at any depth) and straggler requeue fails over *all* chunks
  queued on a quarantined client.

Adaptive chunk sizing
---------------------
With ``chunk_budget_s`` set, the scheduler replaces the static
``batch_size`` by targeting a wall-time budget per chunk: each completed
chunk updates the owner's EWMA of per-config wall time (measured from when
the client could *start* the chunk, so queue wait in pipelined mode is not
counted), and the next chunk dispatched to that client is sized
``budget / ewma`` (clamped).  Fast clients get bigger chunks, slow or
jittery clients get smaller ones, and no client holds a chunk much longer
than the budget — which bounds straggler-detection latency too.

Compile-affinity placement
--------------------------
On a real fleet the dominant cost is artifact *builds* (TensorRT engines /
jit compiles: seconds), not measurements (milliseconds).  With a
``fingerprint_fn`` (normally ``JConfig.cache_key``) the scheduler makes
artifact placement a first-class input: every slot carries a ``CacheShadow``
— an LRU-faithful model of the client's artifact cache, marked optimistically
at dispatch, confirmed from result messages' ``cached`` flags, and resynced
from the ``cache_info`` summary a client attaches to each chunk reply — and
``next_dispatches`` assembles chunks from per-fingerprint buckets of the
pending queue so each dispatch is at most a few compile groups:

* ``affinity="off"``    — FIFO chunks, fixed slot order.
* ``affinity="prefer"`` — a slot takes groups already resident in its
  shadow first (largest first — tightest compile packing), then unclaimed
  groups (becoming their home), and steals a group resident on another
  healthy client only when it would otherwise sit completely idle.
* ``affinity="strict"`` — never steals: a group resident on a healthy
  client waits for that client (its shadow is cleared on quarantine, so a
  dead home never strands work).

Speculative re-dispatch
-----------------------
With ``speculate_frac`` set, a running head chunk that has consumed that
fraction of its deadline budget without completing is mirrored to a second
client — chosen by shadow affinity, falling back to least-loaded.  First
answer wins: results are deduped by the existing first-answer-only inflight
table, the losing twin chunk is cancelled host-side (removed from its
slot's queue; its late answers ride the existing duplicate path), and a
quarantined primary hands its configs to the live mirror instead of
re-queueing them.  The losing client may still be computing the cancelled
chunk, so its next EWMA observation can read slightly slow — the price of
never waiting out a full deadline on a straggler.

With ``speculate_slow_mult`` set (independently of ``speculate_frac``),
chunks still *queued* — not yet started — behind a client whose per-config
EWMA exceeds that multiple of the median of the other healthy clients'
EWMAs are mirrored too ("queued" kind): the slow client has not begun them,
so a copy elsewhere is pure insurance.  ``stats()`` reports the queued-kind
dispatch and win counters separately (``spec_queued*``).

Fair-share multi-tenancy
------------------------
``submit(tc, tenant=...)`` routes configs into per-tenant pending queues
(``add_tenant`` registers a weight, a priority class, and an optional
in-flight cap; a ``"default"`` tenant always exists, so single-sweep
callers see the old behaviour unchanged — bit for bit).  Every dispatched
chunk draws from exactly ONE tenant's queue, picked per chunk opportunity
by (highest priority class, then largest deficit): a deficit-weighted
round-robin where dispatching a chunk of estimated cost
``size × cost_ewma`` charges the tenant ``cost / weight`` credits, so each
tenant's share of fleet wall-clock converges to its weight within a
priority class regardless of per-config cost.  A tenant going idle keeps
its deficit clamped to the most-favoured active tenant's on reactivation,
so banked idle time cannot be spent monopolizing the fleet later.
Priorities preempt *queue position only* — in-flight work is never
revoked.  Per-tenant in-flight caps bound how many of a tenant's configs
may occupy the fleet at once, and a tenant's retries rejoin its own
queue, so a quarantine storm or a giant space in one tenant cannot starve
another.  Affinity, the fleet store, and speculation stay fleet-global:
tenants share one artifact-cache namespace (keyed on
``JConfig.identity()``) and warm each other's compiles for free.

The scheduler is transport-free and clock-injectable: the host pushes the
chunks ``next_dispatches()`` returns, feeds every pulled result to
``on_result()``, and calls ``expire()`` each poll; unit tests drive the same
API with a fake clock and no threads.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, Hashable, List, Optional,
                    Sequence, Set, Tuple)

from repro_torch.core.jconfig import TestConfig

POLICIES = ("eager", "pipelined")
AFFINITIES = ("off", "prefer", "strict")


class CacheShadow:
    """Host-side model of one client's artifact LRU.

    Mirrors ``JClient._artifact`` exactly: a hit refreshes the key's
    recency; a miss inserts it, evicting the least-recently-used entry
    first when the cache is already at capacity.  Each entry records
    whether it is *confirmed* (learned from a result message: the client
    really holds it) or an *optimistic* dispatch mark (the client will hold
    it once it evaluates the chunk — unless the chunk fails).  ``resync``
    folds in the authoritative ``cache_info`` counters a client attaches
    to its chunk replies: when the model holds more entries than the
    client reports, the newest unconfirmed marks are dropped first, and
    only then confirmed entries from the LRU end.
    """

    __slots__ = ("capacity", "_d", "evictions")

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._d: Dict[Hashable, bool] = {}   # fp -> confirmed; ins. order
        self.evictions = 0                   # == LRU order

    def __contains__(self, fp: Hashable) -> bool:
        return fp in self._d

    def __len__(self) -> int:
        return len(self._d)

    def keys(self) -> List[Hashable]:
        """Resident fingerprints, least-recently-used first."""
        return list(self._d)

    def touch(self, fp: Hashable, confirmed: bool = True) -> bool:
        """Mark ``fp`` used; returns True when it was already resident."""
        if fp in self._d:
            # refresh recency (true LRU); confirmation is sticky
            self._d[fp] = self._d.pop(fp) or confirmed
            return True
        if len(self._d) >= self.capacity:            # evict before insert,
            self._d.pop(next(iter(self._d)))         # like JClient._artifact
            self.evictions += 1
        self._d[fp] = confirmed
        return False

    def resync(self, currsize: Optional[int], maxsize: Optional[int]) -> None:
        if maxsize is not None and maxsize > 0:
            self.capacity = int(maxsize)
        if currsize is None:
            return
        excess = len(self._d) - max(int(currsize), 0)
        if excess <= 0:
            return
        # the model drifted ahead of the client: unconfirmed optimistic
        # marks (e.g. for a chunk that failed) are the suspects — drop the
        # newest of those first, never a confirmed-resident entry before
        # every optimistic one is gone
        for fp in [f for f, ok in reversed(self._d.items()) if not ok]:
            if excess <= 0:
                break
            del self._d[fp]
            excess -= 1
        while excess > 0:
            self._d.pop(next(iter(self._d)))         # confirmed: LRU-first
            excess -= 1

    def clear(self) -> None:
        self._d.clear()


class Chunk:
    """One dispatched chunk: owner, deadline, and unanswered config_ids."""

    __slots__ = ("chunk_id", "client", "deadline", "awaiting", "size",
                 "started_at", "started_seq", "fps", "mirror_id", "mirror_of",
                 "spec_kind", "tenant")

    def __init__(self, chunk_id: int, client: int, deadline: float,
                 awaiting: Set[int], started_at: Optional[float],
                 tenant: str = "default"):
        self.chunk_id = chunk_id
        self.client = client
        self.deadline = deadline
        self.awaiting = awaiting
        self.size = len(awaiting)
        # which tenant's queue this chunk was assembled from (single-tenant
        # chunks keep fair-share accounting and wire tagging trivial)
        self.tenant = tenant
        # when the client could begin working on it: dispatch time for the
        # pipeline head, else set when the predecessor chunk completes (None
        # while queued behind another chunk)
        self.started_at = started_at
        # which result batch (pull sequence) marked it started, if any —
        # used to detect client-side chunk coalescing (see _complete_chunk)
        self.started_seq: Optional[int] = None
        # ordered unique sw fingerprints of the chunk's configs (known only
        # when the scheduler has a fingerprint_fn)
        self.fps: List[Hashable] = []
        # speculative-twin links: a primary points at its mirror and vice
        # versa; both awaiting sets shrink in lockstep (first answer wins)
        self.mirror_id: Optional[int] = None    # set on the primary
        self.mirror_of: Optional[int] = None    # set on the mirror
        # why a mirror exists: "deadline" (speculate_frac on a running head)
        # or "queued" (speculate_slow_mult on a not-yet-started chunk queued
        # behind a very slow client) — routes win/cancel counters
        self.spec_kind: Optional[str] = None    # set on the mirror


class ClientSlot:
    """Per-client pipeline: queued chunks, wall-time EWMA, quarantine, and
    the shadow of the client's artifact cache."""

    __slots__ = ("client_id", "depth_target", "chunks", "ewma_per_cfg_s",
                 "quarantined", "draining", "ewma_prev", "obs_start",
                 "obs_configs", "shadow")

    def __init__(self, client_id: int, depth_target: int,
                 cache_size: int = 64):
        self.client_id = client_id
        self.depth_target = depth_target
        self.chunks: List[int] = []         # FIFO of chunk_ids
        self.ewma_per_cfg_s: Optional[float] = None
        self.quarantined = False
        # graceful-leave state: a draining client receives no new chunks but
        # finishes the ones it holds; the slot retires when they complete
        self.draining = False
        self.shadow = CacheShadow(cache_size)
        # last EWMA observation, kept revisable: when the client coalesced
        # queued chunks into one evaluate_batch, the successor chunk
        # completes in the same result frame with ~zero measured duration —
        # the predecessor's span covered its work, so the observation is
        # re-done over the combined configs instead of recording a bogus
        # near-zero sample that would deflate the EWMA
        self.ewma_prev: Optional[float] = None
        self.obs_start: Optional[float] = None
        self.obs_configs: int = 0

    def open_chunks(self) -> int:
        return 0 if self.quarantined or self.draining else max(
            self.depth_target - len(self.chunks), 0)


class TenantState:
    """Per-tenant fair-share state: the pending queue plus the DWRR books.

    ``deficit`` is the tenant's credit balance: dispatching a chunk of
    estimated cost ``size × cost_ewma`` charges ``cost / weight``, and the
    scheduler always serves the eligible tenant with the *largest* deficit
    (within the highest non-empty priority class), so long-run fleet time
    splits by weight however lopsided per-config costs are.  ``cost_ewma``
    is the tenant's own observed per-config wall-time average (seeded 1.0
    until the first chunk completes).  ``max_inflight`` caps how many of
    the tenant's configs may be in flight at once (None = uncapped);
    ``priority`` classes are served strictly high-to-low, but only for
    *queue position* — a lower-priority chunk already dispatched is never
    revoked.
    """

    __slots__ = ("name", "seq", "queue", "weight", "priority", "max_inflight",
                 "deficit", "inflight", "cost_ewma", "n_submitted",
                 "n_dispatched", "n_done")

    def __init__(self, name: str, seq: int, *, weight: float = 1.0,
                 priority: int = 0, max_inflight: Optional[int] = None):
        self.name = name
        self.seq = seq                       # registration order: tie-break
        self.queue: Deque[Tuple[TestConfig, int]] = deque()
        self.weight = weight
        self.priority = priority
        self.max_inflight = max_inflight
        self.deficit = 0.0
        self.inflight = 0                    # configs in the inflight table
        self.cost_ewma: Optional[float] = None
        self.n_submitted = 0
        self.n_dispatched = 0
        self.n_done = 0

    def headroom(self) -> Optional[int]:
        """Configs this tenant may still put in flight (None = unbounded)."""
        if self.max_inflight is None:
            return None
        return max(self.max_inflight - self.inflight, 0)

    def eligible(self) -> bool:
        return bool(self.queue) and (self.max_inflight is None
                                     or self.inflight < self.max_inflight)


class DispatchScheduler:
    def __init__(self, client_ids: Sequence[int], *,
                 policy: str = "eager",
                 timeout_s: float = 600.0,
                 max_retries: int = 2,
                 batch_size: Optional[int] = None,
                 chunk_budget_s: Optional[float] = None,
                 min_chunk: int = 1,
                 max_chunk: int = 512,
                 ewma_alpha: float = 0.25,
                 affinity: str = "off",
                 fingerprint_fn: Optional[Callable[[TestConfig],
                                                   Hashable]] = None,
                 client_cache_size: int = 64,
                 speculate_frac: Optional[float] = None,
                 speculate_slow_mult: Optional[float] = None,
                 pipeline_depth: Optional[int] = None,
                 fleet_resident_fn: Optional[Callable[[Hashable],
                                                      bool]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        if affinity not in AFFINITIES:
            raise ValueError(
                f"affinity must be one of {AFFINITIES}, got {affinity!r}")
        if affinity != "off" and fingerprint_fn is None:
            raise ValueError("affinity placement needs a fingerprint_fn "
                             "(e.g. JConfig.cache_key)")
        if speculate_frac is not None and not 0.0 < speculate_frac <= 1.0:
            raise ValueError(f"speculate_frac must be in (0, 1], "
                             f"got {speculate_frac!r}")
        if speculate_slow_mult is not None and speculate_slow_mult <= 1.0:
            raise ValueError(f"speculate_slow_mult must be > 1.0, "
                             f"got {speculate_slow_mult!r}")
        if pipeline_depth is not None:
            depth = int(pipeline_depth)
            if depth < 1:
                raise ValueError(f"pipeline_depth must be >= 1, got {depth}")
        else:
            depth = 2 if policy == "pipelined" else 1
        self.policy = policy
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.chunk_budget_s = chunk_budget_s
        self.min_chunk = min_chunk
        self.max_chunk = max_chunk
        self.ewma_alpha = ewma_alpha
        self.affinity = affinity
        self.fingerprint_fn = fingerprint_fn
        self.speculate_frac = speculate_frac
        self.speculate_slow_mult = speculate_slow_mult
        # fleet artifact store consult: fingerprint -> "resident somewhere
        # in the fleet" (host blob cache / peer disk / compile in flight).
        # A fleet-resident group costs a fetch, not a compile, wherever it
        # lands — so it neither binds placement nor consumes the
        # one-fresh-compile-group-per-chunk budget
        self.fleet_resident_fn = fleet_resident_fn
        self.clock = clock
        # before any EWMA exists: the static batch_size, or a modest seed
        # chunk when only a budget was given (it adapts from there)
        self.base_chunk = max(int(batch_size or (8 if chunk_budget_s else 1)), 1)
        # retained so clients joining mid-run (add_client) get slots built
        # exactly like the construction-time ones
        self._depth = depth
        self._client_cache_size = client_cache_size
        self.slots: Dict[int, ClientSlot] = {
            c: ClientSlot(c, depth, client_cache_size) for c in client_ids}
        # per-tenant pending queues; the "default" tenant always exists so
        # single-sweep callers never see the tenancy layer
        self._tenant_seq = itertools.count()
        self.tenants: Dict[str, TenantState] = {
            "default": TenantState("default", next(self._tenant_seq))}
        self._tenant_of: Dict[int, str] = {}  # config_id -> tenant name
        self.inflight: Dict[int, dict] = {}   # config_id -> {tc, chunk, retries}
        self.chunks: Dict[int, Chunk] = {}
        self.quarantined: Set[int] = set()
        self._chunk_ids = itertools.count()
        self._pull_seq = 0
        self._fp: Dict[int, Hashable] = {}    # config_id -> sw fingerprint
        # repr(fp) -> fp memo: a HELLO's resident_fps sidecar crosses the
        # wire as repr strings, and this maps them back to live fingerprint
        # objects so a joining client's shadow warms from its on-disk cache
        self._fp_by_repr: Dict[str, Hashable] = {}
        self.n_clients_joined = 0
        self.n_clients_left = 0
        self.n_chunks_dispatched = 0
        self.n_configs_dispatched = 0
        self.n_fp_chunks = 0        # chunks whose fingerprints were known
        self.n_affine_chunks = 0    # ... placed on a client already holding
        #                             their leading fingerprint
        self.n_fleet_rides = 0      # fresh groups taken free: fleet-resident
        self.n_speculated = 0       # mirror chunks dispatched (all kinds)
        self.n_spec_wins_primary = 0
        self.n_spec_wins_mirror = 0
        self.n_spec_cancelled = 0   # losing twins cancelled host-side
        self.n_spec_queued = 0      # queued-chunk mirrors (slow-client kind)
        self.n_spec_queued_wins_primary = 0
        self.n_spec_queued_wins_mirror = 0
        # optional wire-stats source (the host attaches its transport's
        # ``wire_summary``); merged into stats() — the scheduler itself
        # stays transport-free
        self.wire_stats_fn: Optional[Callable[[], Dict]] = None

    # -- tenancy --------------------------------------------------------------
    @property
    def pending(self) -> Deque[Tuple[TestConfig, int]]:
        """Back-compat view of the pending work.

        With one tenant (the default single-sweep case) this IS that
        tenant's live deque; with several it is a merged read-only snapshot
        in tenant-registration order.
        """
        if len(self.tenants) == 1:
            return next(iter(self.tenants.values())).queue
        merged: Deque[Tuple[TestConfig, int]] = deque()
        for t in self.tenants.values():
            merged.extend(t.queue)
        return merged

    def _total_pending(self) -> int:
        return sum(len(t.queue) for t in self.tenants.values())

    def add_tenant(self, name: str, *, weight: float = 1.0,
                   priority: int = 0,
                   max_inflight: Optional[int] = None) -> TenantState:
        """Register (or re-tune) a tenant's fair-share parameters."""
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight!r}")
        if max_inflight is not None and max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight!r}")
        t = self.tenants.get(name)
        if t is None:
            t = TenantState(name, next(self._tenant_seq), weight=weight,
                            priority=priority, max_inflight=max_inflight)
            self.tenants[name] = t
        else:
            t.weight = weight
            t.priority = priority
            t.max_inflight = max_inflight
        return t

    def cancel_tenant(self, name: str) -> Tuple[int, int]:
        """Drop a tenant's queued work and orphan its in-flight configs.

        Returns ``(n_queued_dropped, n_inflight_orphaned)``.  In-flight
        configs are removed from the inflight table — the clients still
        evaluating them will answer, and those answers ride the existing
        duplicate path (chunk bookkeeping completes, no result surfaces).
        The tenant stays registered (idle) so its counters remain readable.
        """
        t = self.tenants.get(name)
        if t is None:
            return (0, 0)
        n_queued = len(t.queue)
        for tc, _ in t.queue:
            self._fp.pop(tc.config_id, None)
            self._tenant_of.pop(tc.config_id, None)
        t.queue.clear()
        orphans = [cid for cid, owner in self._tenant_of.items()
                   if owner == name and cid in self.inflight]
        for cid in orphans:
            del self.inflight[cid]
            self._fp.pop(cid, None)
            self._tenant_of.pop(cid, None)
            t.inflight -= 1
        return (n_queued, len(orphans))

    def tenant_of(self, config_id: int) -> str:
        """Which tenant a submitted-but-unfinished config belongs to."""
        return self._tenant_of.get(config_id, "default")

    def _tenant_order(self, headroom_only: bool = True) -> List[TenantState]:
        """Tenants in serve order: priority class high-to-low, then largest
        deficit, then registration order (deterministic tie-break)."""
        pool = [t for t in self.tenants.values()
                if (t.eligible() if headroom_only else t.queue)]
        pool.sort(key=lambda t: (-t.priority, -t.deficit, t.seq))
        return pool

    def _charge(self, tenant: TenantState, n_configs: int) -> None:
        cost = n_configs * (tenant.cost_ewma or 1.0)
        tenant.deficit -= cost / tenant.weight
        tenant.inflight += n_configs
        tenant.n_dispatched += n_configs

    # -- sizing ---------------------------------------------------------------
    def chunk_size_for(self, slot: ClientSlot) -> int:
        if self.chunk_budget_s is not None and slot.ewma_per_cfg_s:
            want = int(round(self.chunk_budget_s / slot.ewma_per_cfg_s))
            return max(self.min_chunk, min(want, self.max_chunk))
        return self.base_chunk

    # -- intake ---------------------------------------------------------------
    def want(self, lookahead: int = 0) -> int:
        """Fresh configs needed to fill every healthy client's pipeline.

        ``lookahead`` adds that many extra chunks per healthy client to the
        demand — the backpressure signal an async ``SearchDriver`` uses to
        size its precompute buffer, so a freed slot tops up from
        already-computed picks instead of blocking on search math.
        """
        capacity = sum((s.open_chunks() + lookahead) * self.chunk_size_for(s)
                       for s in self.slots.values()
                       if not s.quarantined and not s.draining)
        return max(capacity - self._total_pending(), 0)

    def want_for(self, tenant: str, lookahead: int = 0) -> int:
        """Fresh configs ``tenant`` should submit to claim its fair share.

        The multi-tenant analogue of ``want()``: the fleet's open capacity
        is split by weight among tenants that currently have work (queued
        or in flight) plus the asking tenant, so one tenant flooding the
        queues cannot zero out another's intake.  An in-flight cap bounds
        the answer to roughly one pipeline's worth past the cap.
        """
        t = self.tenants.get(tenant)
        if t is None:
            return 0
        capacity = sum((s.open_chunks() + lookahead) * self.chunk_size_for(s)
                       for s in self.slots.values()
                       if not s.quarantined and not s.draining)
        live = [x for x in self.tenants.values()
                if x.queue or x.inflight or x is t]
        total_w = sum(x.weight for x in live)
        share = capacity * (t.weight / total_w) if total_w > 0 else capacity
        want = max(int(share + 0.999999) - len(t.queue), 0)
        if t.max_inflight is not None:
            # past the cap, queued configs just sit — keep at most one
            # cap's worth of runway buffered ahead of the in-flight window
            runway = max(2 * t.max_inflight - t.inflight - len(t.queue), 0)
            want = min(want, runway)
        return want

    def busy(self) -> bool:
        """Anything to wait on?  False means the host cannot make progress
        without fresh submissions — the condition under which it should
        block on the search instead of polling an idle transport."""
        return bool(self.inflight) or self._total_pending() > 0

    def submit(self, tc: TestConfig, tenant: str = "default") -> None:
        t = self.tenants.get(tenant)
        if t is None:
            t = self.add_tenant(tenant)
        if not t.queue and not t.inflight and len(self.tenants) > 1:
            # reactivation clamp: an idle tenant's banked credit is capped
            # at the most-favoured *active* tenant's balance, so returning
            # from idle competes fairly instead of monopolizing the fleet
            active = [x.deficit for x in self.tenants.values()
                      if x is not t and (x.queue or x.inflight)]
            if active:
                t.deficit = min(t.deficit, max(active))
        if self.fingerprint_fn is not None:
            fp = self.fingerprint_fn(tc)
            self._fp[tc.config_id] = fp
            self._fp_by_repr[repr(fp)] = fp
        self._tenant_of[tc.config_id] = tenant
        t.queue.append((tc, self.max_retries))
        t.n_submitted += 1

    # -- membership -----------------------------------------------------------
    def add_client(self, client_id: int,
                   resident_fps: Optional[Sequence] = None) -> ClientSlot:
        """Admit a client appearing mid-run (transport HELLO).

        A returning client (known id) is un-quarantined and un-drained
        rather than rebuilt, keeping its EWMA; a new one gets a fresh slot
        built with the construction-time depth/cache-size.  ``resident_fps``
        (fingerprints, or their repr strings as the wire carries them) warm
        the slot's shadow so affinity placement engages immediately.
        """
        slot = self.slots.get(client_id)
        if slot is None:
            slot = ClientSlot(client_id, self._depth, self._client_cache_size)
            self.slots[client_id] = slot
        slot.quarantined = False
        slot.draining = False
        self.quarantined.discard(client_id)
        for f in resident_fps or ():
            fp = self._fp_by_repr.get(f, f) if isinstance(f, str) else f
            slot.shadow.touch(fp, confirmed=True)
        self.n_clients_joined += 1
        return slot

    def remove_client(self, client_id: int, drain: bool = True) -> None:
        """Retire a client (transport GOODBYE).

        ``drain=True`` (graceful leave): the slot stops receiving chunks and
        retires once the ones it holds complete — no config is lost or even
        re-queued.  ``drain=False`` (hard leave): its queued chunks fail over
        through the same twin-re-point/re-queue path a quarantine uses, but
        *without* consuming a retry — leaving is not a failure.
        """
        slot = self.slots.get(client_id)
        if slot is None:
            self.quarantined.discard(client_id)
            return
        if drain and slot.chunks:
            slot.draining = True
            return
        self._fail_over_slot(slot, consume_retry=False)
        del self.slots[client_id]
        self.quarantined.discard(client_id)
        self.n_clients_left += 1

    # -- dispatch -------------------------------------------------------------
    def next_dispatches(self) -> List[Tuple[int, List[TestConfig]]]:
        """Chunks ready to ship: (client_id, configs), pipeline-fair.

        With affinity on, slots fill least-loaded-first from per-fingerprint
        buckets of the pending queue (see ``_take_affine``); speculative
        mirrors of nearly-expired chunks are emitted first, so a straggler's
        insurance rides the same push the fresh work does.
        """
        out: List[Tuple[int, List[TestConfig]]] = []
        if self.speculate_frac is not None or \
                self.speculate_slow_mult is not None:
            out.extend(self._speculative_dispatches())
        if not self._total_pending() or not any(
                s.open_chunks() for s in self.slots.values()):
            return out                # steady state: skip the bucketing work
        if self.affinity == "off":
            progress = True
            while self._total_pending() and progress:
                progress = False
                # one chunk per slot per pass keeps clients evenly loaded
                for slot in self.slots.values():
                    if not self._total_pending():
                        break
                    if slot.open_chunks() == 0:
                        continue
                    order = self._tenant_order()
                    if not order:
                        break         # all queued tenants are at their caps
                    tenant = order[0]
                    size = min(self.chunk_size_for(slot), len(tenant.queue))
                    head = tenant.headroom()
                    if head is not None:
                        size = min(size, head)
                    items = [tenant.queue.popleft() for _ in range(size)]
                    out.append((slot.client_id,
                                self._dispatch(slot, items, tenant)))
                    progress = True
            return out
        # affinity: bucket each tenant's queue by fingerprint ONCE per call
        # (arrival order preserved per bucket and, via seq, overall), then
        # let every slot-pass consume from the picked tenant's buckets
        groups_of: Dict[str, Dict[Hashable,
                                  Deque[Tuple[int,
                                              Tuple[TestConfig, int]]]]] = {}
        remaining: Dict[str, int] = {}
        for t in self.tenants.values():
            if not t.queue:
                continue
            groups: Dict[Hashable, Deque] = {}
            for seq, item in enumerate(t.queue):
                fp = self._fp.get(item[0].config_id)
                if fp not in groups:
                    groups[fp] = deque()
                groups[fp].append((seq, item))
            groups_of[t.name] = groups
            remaining[t.name] = len(t.queue)
        n_left = sum(remaining.values())
        progress = True
        while n_left and progress:
            progress = False
            # least-loaded first so the non-affine fallback balances
            for slot in sorted(self.slots.values(),
                               key=lambda s: (len(s.chunks), s.client_id)):
                if n_left == 0:
                    break
                if slot.open_chunks() == 0:
                    continue
                # fairness picks the tenant, affinity picks within it; a
                # tenant whose groups all live elsewhere (strict) yields
                # nothing for this slot — fall through to the next tenant
                for tenant in self._tenant_order():
                    groups = groups_of.get(tenant.name)
                    if not groups or remaining[tenant.name] == 0:
                        continue
                    size = min(self.chunk_size_for(slot),
                               remaining[tenant.name])
                    head = tenant.headroom()
                    if head is not None:
                        size = min(size, head)
                    if size == 0:
                        continue
                    items = self._take_affine(slot, size, groups)
                    if not items:
                        continue  # strict: this slot's work lives elsewhere
                    remaining[tenant.name] -= len(items)
                    n_left -= len(items)
                    out.append((slot.client_id,
                                self._dispatch(slot, items, tenant)))
                    progress = True
                    break
        for name, groups in groups_of.items():
            t = self.tenants[name]
            if remaining[name] == len(t.queue):
                continue              # nothing consumed: queue is untouched
            left = sorted((e for q in groups.values() for e in q),
                          key=lambda e: e[0])
            t.queue.clear()
            t.queue.extend(item for _, item in left)
        return out

    def _take_affine(self, slot: ClientSlot, size: int,
                     groups: Dict[Hashable, Deque]) -> List[Tuple[TestConfig,
                                                                  int]]:
        """Up to ``size`` items for ``slot``, consumed from the shared
        per-fingerprint buckets.

        Groups are ranked: resident in this slot's shadow first (largest
        first — tightest compile packing), then groups the *fleet store*
        already holds (a fetch, not a compile, wherever they land), then
        groups resident on no healthy client (this slot becomes their
        home), then — only in ``prefer`` mode and only when the slot is
        completely idle — groups resident on another healthy client.
        Whole groups are taken head-first until the chunk is full, so a
        dispatch is at most a few compile groups — and at most ONE of them
        not yet compiled anywhere: padding a chunk with the head of a
        second fresh group would claim it for this client, skewing group
        ownership across the fleet and serializing its compiles here;
        resident groups — shadow- or fleet-resident — are free riders.
        """
        here: List[Hashable] = []
        fleet: List[Hashable] = []
        unclaimed: List[Hashable] = []
        elsewhere: List[Hashable] = []
        for fp, q in groups.items():
            if not q:
                continue
            if fp is not None and fp in slot.shadow:
                here.append(fp)
            elif fp is not None and self._fleet_resident(fp):
                fleet.append(fp)         # fetchable anywhere: free rider
            elif fp is not None and any(
                    fp in s.shadow for s in self.slots.values()
                    if s is not slot and not s.quarantined):
                elsewhere.append(fp)
            else:
                unclaimed.append(fp)     # no affinity signal: first taker
        here.sort(key=lambda f: -len(groups[f]))
        fleet.sort(key=lambda f: -len(groups[f]))
        ranked = here + fleet + unclaimed
        if self.affinity == "prefer" and not slot.chunks:
            ranked += elsewhere          # steal rather than idle
        fleet_set = set(fleet)
        taken: List[Tuple[TestConfig, int]] = []
        new_group_taken = False
        for fp in ranked:
            if len(taken) >= size:
                break
            free = (fp is not None and fp in slot.shadow) or fp in fleet_set
            if not free:
                if new_group_taken:      # one fresh compile group per chunk
                    continue
                new_group_taken = True
            q = groups[fp]
            took_any = False
            while q and len(taken) < size:
                taken.append(q.popleft()[1])
                took_any = True
            if took_any and fp in fleet_set:
                self.n_fleet_rides += 1
        return taken

    def _fleet_resident(self, fp: Hashable) -> bool:
        if self.fleet_resident_fn is None:
            return False
        try:
            return bool(self.fleet_resident_fn(fp))
        except Exception:
            return False  # a stats probe must never take dispatch down

    def _dispatch(self, slot: ClientSlot,
                  items: List[Tuple[TestConfig, int]],
                  tenant: Optional[TenantState] = None) -> List[TestConfig]:
        now = self.clock()
        chunk_id = next(self._chunk_ids)
        if slot.chunks:
            # a queued chunk's budget starts where its predecessor's ends:
            # the client cannot have begun it yet
            base = max(now, self.chunks[slot.chunks[-1]].deadline)
            started = None
        else:
            base = now
            started = now
        chunk = Chunk(chunk_id, slot.client_id,
                      deadline=base + self.timeout_s * len(items),
                      awaiting={tc.config_id for tc, _ in items},
                      started_at=started,
                      tenant=tenant.name if tenant is not None else "default")
        if tenant is not None:
            self._charge(tenant, len(items))
        if self.fingerprint_fn is not None:
            seen: Set[Hashable] = set()
            for tc, _ in items:
                fp = self._fp.get(tc.config_id)
                if fp is not None and fp not in seen:
                    seen.add(fp)
                    chunk.fps.append(fp)
            if chunk.fps:
                self.n_fp_chunks += 1
                if chunk.fps[0] in slot.shadow:
                    self.n_affine_chunks += 1
                # optimistic: the client will hold these once it evaluates
                # the chunk (confirmed/corrected by result `cached` flags
                # and the reply's cache_info resync)
                for fp in chunk.fps:
                    slot.shadow.touch(fp, confirmed=False)
        self.chunks[chunk_id] = chunk
        slot.chunks.append(chunk_id)
        for tc, retries in items:
            self.inflight[tc.config_id] = {"tc": tc, "chunk": chunk_id,
                                           "retries": retries}
        self.n_chunks_dispatched += 1
        self.n_configs_dispatched += len(items)
        return [tc for tc, _ in items]

    # -- speculation ----------------------------------------------------------
    def _speculative_dispatches(self) -> List[Tuple[int, List[TestConfig]]]:
        """Mirror chunks at risk onto a second client (shadow-affine, else
        least loaded).  Two triggers, independently enabled: a *running*
        head chunk that burned ``speculate_frac`` of its deadline budget
        ("deadline" kind), and chunks still *queued* (not yet started)
        behind a client whose per-config EWMA exceeds
        ``speculate_slow_mult`` × the median of the other healthy clients'
        EWMAs ("queued" kind — the work hasn't begun, so moving a copy is
        pure insurance, not a race against sunk cost).  First answer wins;
        see ``_cancel_twin``."""
        now = self.clock()
        out: List[Tuple[int, List[TestConfig]]] = []
        if self.speculate_frac is not None:
            for slot in self.slots.values():
                if slot.quarantined or not slot.chunks:
                    continue
                head = self.chunks[slot.chunks[0]]
                if (head.mirror_id is not None or head.mirror_of is not None
                        or head.started_at is None or not head.awaiting):
                    continue
                budget = head.deadline - head.started_at
                if budget <= 0 or (now - head.started_at) < \
                        self.speculate_frac * budget:
                    continue
                target = self._mirror_target(slot, head)
                if target is None:
                    continue
                disp = self._mirror_chunk(head, target, now, "deadline")
                if disp is not None:
                    out.append(disp)
        if self.speculate_slow_mult is not None:
            out.extend(self._queued_speculative(now))
        return out

    def _queued_speculative(self, now: float
                            ) -> List[Tuple[int, List[TestConfig]]]:
        """Mirror queued (not yet started) chunks of very slow clients."""
        mult = self.speculate_slow_mult
        out: List[Tuple[int, List[TestConfig]]] = []
        healthy = [s for s in self.slots.values()
                   if not s.quarantined and s.ewma_per_cfg_s is not None]
        for slot in healthy:
            if len(slot.chunks) < 2:
                continue
            # median of the OTHER healthy clients' EWMAs: with the slow slot
            # excluded, a 2-client fleet still yields a sane reference (a
            # plain all-slots median would sit between the two speeds)
            others = sorted(s.ewma_per_cfg_s for s in healthy if s is not slot)
            if not others:
                continue
            ref = others[len(others) // 2] if len(others) % 2 else \
                0.5 * (others[len(others) // 2 - 1]
                       + others[len(others) // 2])
            if ref <= 0 or slot.ewma_per_cfg_s <= mult * ref:
                continue
            for chunk_id in list(slot.chunks[1:]):
                chunk = self.chunks[chunk_id]
                if (chunk.started_at is not None
                        or chunk.mirror_id is not None
                        or chunk.mirror_of is not None
                        or not chunk.awaiting):
                    continue
                target = self._mirror_target(slot, chunk)
                if target is None:
                    return out             # fleet has no spare depth left
                disp = self._mirror_chunk(chunk, target, now, "queued")
                if disp is not None:
                    self.n_spec_queued += 1
                    out.append(disp)
        return out

    def _mirror_chunk(self, src: Chunk, target: ClientSlot, now: float,
                      kind: str) -> Optional[Tuple[int, List[TestConfig]]]:
        """Create and enqueue the speculative twin of ``src`` on ``target``.

        Mirrors only what is still unanswered AND in flight: a cid the owner
        still awaits but a late straggler already answered is not re-sent,
        so it must not be awaited from the mirror either (it could never
        answer it — the chunk would hang forever)."""
        tcs = [self.inflight[c]["tc"] for c in sorted(src.awaiting)
               if c in self.inflight]
        if not tcs:
            return None
        mirror_id = next(self._chunk_ids)
        if target.chunks:
            base = max(now, self.chunks[target.chunks[-1]].deadline)
            started = None
        else:
            base = now
            started = now
        # a mirror rides its source's tenant tag but is never re-charged:
        # speculation is fleet-global insurance, not tenant demand
        mirror = Chunk(mirror_id, target.client_id,
                       deadline=base + self.timeout_s * len(tcs),
                       awaiting={tc.config_id for tc in tcs},
                       started_at=started, tenant=src.tenant)
        mirror.mirror_of = src.chunk_id
        mirror.spec_kind = kind
        mirror.fps = list(src.fps)
        src.mirror_id = mirror_id
        self.chunks[mirror_id] = mirror
        target.chunks.append(mirror_id)
        for fp in mirror.fps:
            target.shadow.touch(fp, confirmed=False)
        self.n_speculated += 1
        return (target.client_id, tcs)

    def _mirror_target(self, owner: ClientSlot,
                       chunk: Chunk) -> Optional[ClientSlot]:
        best: Optional[Tuple[Tuple[int, int, int], ClientSlot]] = None
        for slot in self.slots.values():
            if slot is owner or slot.quarantined or slot.open_chunks() == 0:
                continue
            overlap = sum(1 for fp in chunk.fps if fp in slot.shadow)
            key = (-overlap, len(slot.chunks), slot.client_id)
            if best is None or key < best[0]:
                best = (key, slot)
        return best[1] if best is not None else None

    def _twin(self, chunk: Chunk) -> Optional[Chunk]:
        tid = chunk.mirror_id if chunk.mirror_id is not None \
            else chunk.mirror_of
        return self.chunks.get(tid) if tid is not None else None

    def _cancel_twin(self, winner: Chunk, loser: Chunk) -> None:
        """Host-side cancel of the losing twin: its slot is freed now; any
        answers the losing client still pushes ride the duplicate path."""
        self.chunks.pop(loser.chunk_id, None)
        lslot = self.slots.get(loser.client)
        if lslot is not None and loser.chunk_id in lslot.chunks:
            was_head = lslot.chunks[0] == loser.chunk_id
            lslot.chunks.remove(loser.chunk_id)
            if was_head and lslot.chunks:
                succ = self.chunks[lslot.chunks[0]]
                if succ.started_at is None:
                    succ.started_at = self.clock()
                    succ.started_seq = self._pull_seq
        winner.mirror_id = winner.mirror_of = None
        self.n_spec_cancelled += 1
        mirror = loser if loser.mirror_of is not None else winner
        queued = mirror.spec_kind == "queued"
        if loser.mirror_of is not None:       # the mirror lost: primary won
            if queued:
                self.n_spec_queued_wins_primary += 1
            else:
                self.n_spec_wins_primary += 1
        else:
            if queued:
                self.n_spec_queued_wins_mirror += 1
            else:
                self.n_spec_wins_mirror += 1

    # -- results --------------------------------------------------------------
    def note_results(self) -> None:
        """Mark a result-frame boundary (one pulled wire frame).

        The host calls this once before feeding each pull's messages to
        ``on_result``.  Chunks that both *start* and *complete* inside the
        same frame were coalesced by the client into the predecessor's
        evaluate_batch — their wall time belongs to the predecessor's span.
        """
        self._pull_seq += 1

    def on_result(self, msg: dict) -> Optional[TestConfig]:
        """Feed one pulled result message.

        Returns the TestConfig if this is the *first* answer for the config
        (the host records it, rehydrating a slim echo from the returned tc),
        or None for duplicates.  Owner bookkeeping runs either way: the
        reporting client finished this config, and is topped up exactly when
        it has answered its whole chunk itself.  Shadow learning rides the
        same message: the reporter's ``CacheShadow`` is touched with the
        config's fingerprint (confirming the optimistic dispatch mark) and
        resynced from any attached ``cache_info`` summary.
        """
        cid = msg.get("config_id")
        info = self.inflight.pop(cid, None) if cid is not None else None
        tc = info["tc"] if info is not None else None
        if info is not None:
            t = self.tenants.get(self._tenant_of.get(cid, "default"))
            if t is not None:
                t.inflight -= 1
                t.n_done += 1
        reporter = msg.get("client_id")
        if reporter is None and info is not None:
            owner = self.chunks.get(info["chunk"])
            reporter = owner.client if owner is not None else None
        slot = self.slots.get(reporter)
        if slot is not None:
            if self.fingerprint_fn is not None:
                fp = self._fp.get(cid)
                if fp is not None and (msg.get("cached")
                                       or msg.get("status") == "ok"):
                    slot.shadow.touch(fp)
                ci = msg.get("cache_info")
                if isinstance(ci, dict):
                    slot.shadow.resync(ci.get("currsize"), ci.get("maxsize"))
            for chunk_id in list(slot.chunks):
                chunk = self.chunks[chunk_id]
                if cid in chunk.awaiting:
                    chunk.awaiting.discard(cid)
                    twin = self._twin(chunk)
                    if twin is not None:
                        # twins shrink in lockstep: the other copy of this
                        # config's work is no longer awaited either
                        twin.awaiting.discard(cid)
                    if not chunk.awaiting:
                        if twin is not None:
                            self._cancel_twin(chunk, twin)
                        self._complete_chunk(slot, chunk)
                    elif twin is not None and not twin.awaiting:
                        # the twin emptied via cross-discards (it awaited a
                        # subset — e.g. a mirror of a chunk with an already
                        # straggler-answered cid): nothing left for it to
                        # answer, so free its slot now
                        self._cancel_twin(chunk, twin)
                    break
            if slot.draining and not slot.chunks:
                # graceful leave complete: every chunk answered, retire now
                del self.slots[slot.client_id]
                self.n_clients_left += 1
        if tc is not None:
            self._fp.pop(cid, None)
            self._tenant_of.pop(cid, None)
        return tc

    def _complete_chunk(self, slot: ClientSlot, chunk: Chunk) -> None:
        now = self.clock()
        del self.chunks[chunk.chunk_id]
        slot.chunks.remove(chunk.chunk_id)
        if chunk.started_at is not None:
            if (chunk.started_seq is not None
                    and chunk.started_seq == self._pull_seq
                    and slot.obs_start is not None):
                # coalesced: started *and* completed inside the same result
                # frame — the predecessor's span already covered this work.
                # Revise the previous observation over the combined configs
                # instead of recording a bogus near-zero sample.
                slot.ewma_per_cfg_s = slot.ewma_prev
                slot.obs_configs += chunk.size
            else:
                slot.ewma_prev = slot.ewma_per_cfg_s
                slot.obs_start = chunk.started_at
                slot.obs_configs = chunk.size
            per_cfg = max((now - slot.obs_start) / slot.obs_configs, 1e-9)
            if slot.ewma_per_cfg_s is None:
                slot.ewma_per_cfg_s = per_cfg
            else:
                slot.ewma_per_cfg_s = (self.ewma_alpha * per_cfg
                                       + (1 - self.ewma_alpha)
                                       * slot.ewma_per_cfg_s)
            # the tenant's own cost model: future deficit charges for this
            # tenant scale with what its configs actually cost the fleet
            t = self.tenants.get(chunk.tenant)
            if t is not None:
                if t.cost_ewma is None:
                    t.cost_ewma = per_cfg
                else:
                    t.cost_ewma = (self.ewma_alpha * per_cfg
                                   + (1 - self.ewma_alpha) * t.cost_ewma)
        if slot.chunks:                       # successor starts now
            head = self.chunks[slot.chunks[0]]
            if head.started_at is None:
                head.started_at = now
                head.started_seq = self._pull_seq

    # -- deadlines ------------------------------------------------------------
    def expire(self) -> List[Tuple[TestConfig, int]]:
        """Straggler sweep.  Quarantines clients that blew a chunk deadline
        and fails over every chunk queued on them: configs covered by a live
        speculative twin are handed to the twin, survivors with retries
        left rejoin the pending queue, and the rest are returned as terminal
        ``(tc, client_id)`` timeouts for the host to record."""
        now = self.clock()
        terminal: List[Tuple[TestConfig, int]] = []
        for chunk_id in list(self.chunks):
            chunk = self.chunks.get(chunk_id)
            if chunk is None or now <= chunk.deadline:
                continue
            slot = self.slots[chunk.client]
            slot.quarantined = True
            self.quarantined.add(chunk.client)
            # the client is gone: chunks queued behind the expired one would
            # never be answered either — fail them all over at once
            terminal.extend(self._fail_over_slot(slot, consume_retry=True))
        return terminal

    def _fail_over_slot(self, slot: ClientSlot, *, consume_retry: bool
                        ) -> List[Tuple[TestConfig, int]]:
        """Re-home every chunk queued on ``slot``: configs covered by a live
        speculative twin are re-pointed at the twin, the rest rejoin the
        pending queue.  ``consume_retry`` distinguishes a quarantine (a
        failure: the retry budget shrinks, exhausted configs are returned
        as terminal timeouts) from a graceful removal (not a failure: the
        config re-queues at full budget, nothing is terminal)."""
        terminal: List[Tuple[TestConfig, int]] = []
        for dead_id in list(slot.chunks):
            dead = self.chunks.pop(dead_id)
            twin = self._twin(dead)
            for cfg_id in sorted(dead.awaiting):
                info = self.inflight.get(cfg_id)
                if info is None or info["chunk"] != dead_id:
                    continue      # already answered (maybe by a peer)
                if twin is not None and cfg_id in twin.awaiting:
                    # the live mirror already carries this config:
                    # re-point ownership instead of re-queueing
                    info["chunk"] = twin.chunk_id
                    continue
                del self.inflight[cfg_id]
                # a failing tenant's retries rejoin its OWN queue: the
                # storm is contained by its deficit and in-flight cap
                owner = self.tenants.get(
                    self._tenant_of.get(cfg_id, "default"))
                if owner is None:
                    owner = self.tenants["default"]
                owner.inflight -= 1
                if not consume_retry:
                    owner.queue.append((info["tc"], info["retries"]))
                elif info["retries"] > 0:
                    owner.queue.append((info["tc"], info["retries"] - 1))
                else:
                    self._fp.pop(cfg_id, None)
                    self._tenant_of.pop(cfg_id, None)
                    owner.n_done += 1
                    terminal.append((info["tc"], slot.client_id))
            if twin is not None:          # survivor completes standalone
                twin.mirror_id = twin.mirror_of = None
        slot.chunks.clear()
        # the client's artifacts are unreachable once it is gone: without
        # this, strict affinity would strand its fingerprints forever
        slot.shadow.clear()
        return terminal

    # -- introspection --------------------------------------------------------
    def resident_fingerprints(self) -> Set[Hashable]:
        """Union of sw fingerprints resident in healthy clients' shadows —
        the fleet-level compile-residency snapshot a shadow-aware searcher
        biases its candidate pools toward (``SearchAlgorithm.note_residency``)."""
        out: Set[Hashable] = set()
        for slot in self.slots.values():
            if not slot.quarantined and not slot.draining:
                out.update(slot.shadow.keys())
        return out

    def stuck(self) -> bool:
        """No work can ever complete: nothing in flight, everyone dead."""
        return (not self.chunks
                and all(s.quarantined for s in self.slots.values()))

    def stats(self) -> Dict[str, Any]:
        busy = sum(1 for s in self.slots.values() if s.chunks)
        s: Dict[str, Any] = {
            "pending": self._total_pending(),
            "inflight": len(self.inflight),
            "chunks": len(self.chunks),
            "busy_clients": busy,
            "quarantined": len(self.quarantined),
            "clients": len(self.slots),
            "clients_joined": self.n_clients_joined,
            "clients_left": self.n_clients_left,
            "chunks_dispatched": self.n_chunks_dispatched,
            "mean_chunk": (self.n_configs_dispatched
                           / max(self.n_chunks_dispatched, 1)),
        }
        if len(self.tenants) > 1:
            s["tenants"] = {
                t.name: {"queued": len(t.queue), "inflight": t.inflight,
                         "submitted": t.n_submitted,
                         "dispatched": t.n_dispatched, "done": t.n_done,
                         "weight": t.weight, "priority": t.priority,
                         "max_inflight": t.max_inflight,
                         "deficit": t.deficit, "cost_ewma": t.cost_ewma}
                for t in self.tenants.values()}
        if self.fingerprint_fn is not None:
            s["affinity"] = self.affinity
            s["fp_chunks"] = self.n_fp_chunks
            s["affine_chunks"] = self.n_affine_chunks
            s["shadow_sizes"] = {c: len(sl.shadow)
                                 for c, sl in self.slots.items()}
        if self.fleet_resident_fn is not None:
            s["fleet_rides"] = self.n_fleet_rides
        if self.speculate_frac is not None or \
                self.speculate_slow_mult is not None:
            s["speculated"] = self.n_speculated
            s["spec_wins_primary"] = self.n_spec_wins_primary
            s["spec_wins_mirror"] = self.n_spec_wins_mirror
            s["spec_cancelled"] = self.n_spec_cancelled
        if self.speculate_slow_mult is not None:
            s["spec_queued"] = self.n_spec_queued
            s["spec_queued_wins_primary"] = self.n_spec_queued_wins_primary
            s["spec_queued_wins_mirror"] = self.n_spec_queued_wins_mirror
        if self.wire_stats_fn is not None:
            try:
                s.update(self.wire_stats_fn() or {})
            except Exception:
                pass          # stats must never take the host loop down
        return s
