"""Fleet-wide artifact store — cross-client sharing of compiled artifacts.

A copy of ``repro/core/fleet.py``.  JClient's persistent cache is
per-client: two boards with the same ``JConfig.identity()`` still each
compile every fingerprint once, so fleet compile cost scales with
*placement* instead of with *unique work*.  This module promotes the
content-addressed disk tier to a host-mediated fleet store — the XLA
persistent-compilation-cache idea lifted to a multi-board fleet:

* A client that misses both its LRU and its disk tier pushes an
  ``ARTIFACT_QUERY`` up its existing result socket (``addr`` = SHA-256 of
  ``repr((JConfig.identity(), cache_key))``, the same address the disk
  tier uses) and blocks briefly for the reply.
* ``FleetArtifactStore`` lives in the host loop (``JHost.explore``
  intercepts artifact frames before scheduler bookkeeping) and keeps the
  fleet-global generalization of the per-slot ``CacheShadow``: a residency
  map ``addr -> {client_ids}`` that also covers each client's *disk* tier
  (shadows are LRU-bounded; residency is not) plus, in ``serve`` mode, a
  byte-budgeted LRU blob cache of pickled ``BuildResult``s.
* ``mode="serve"`` — clients announce every fresh compile with the blob
  attached; the host caches it and serves later queries directly (one
  client→host upload per unique fingerprint, then host→client downloads).
* ``mode="relay"`` — clients announce residency only (no upload); on a
  query the host relays an ``ARTIFACT_FETCH`` to a resident peer and
  forwards the returned blob to the waiters without retaining it (host
  memory stays O(residency map), the blob crosses the wire twice).

Exactly-F compiles
------------------
The invariant the scheduler alone cannot give under arbitrary placement —
N clients × F fingerprints → exactly F fleet compiles — comes from the
store serializing compiles per address: the *first* query for an unknown
address gets ``ARTIFACT_MISS`` back and its sender becomes the designated
compiler; every later query for the same address parks in a waiter list
until the compiler's ``ARTIFACT_PUT`` lands, then gets served the blob (or
relayed to the now-resident compiler).  A designated compiler is never
itself blocked on the fleet (it queries exactly when it is about to
build), so the wait chain cannot deadlock; if the compiler dies anyway,
``tick()`` expires the assignment and the waiters get a MISS to compile
for themselves.

Large engines stream as ``ARTIFACT_CHUNK`` runs (``transport.chunk_blob``
/ ``ChunkAssembler``); the binary codec carries the ``blob`` bytes as raw
segments (no JSON/base64 detour — see ``repro_torch.core.codec``).

``DispatchScheduler`` consults ``resident_fp`` (via ``fleet_resident_fn``)
before homing a fresh compile group: a fingerprint the fleet already holds
is a free rider — fetching it is milliseconds, not a compile.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.transport import (ARTIFACT_CHUNK, ARTIFACT_FETCH,
                                  ARTIFACT_MISS, ARTIFACT_PUT,
                                  ARTIFACT_QUERY, ChunkAssembler, chunk_blob,
                                  is_artifact_msg)

MODES = ("serve", "relay")


class FleetArtifactStore:
    """Host-side fleet residency map + (serve mode) blob cache.

    Transport-free and clock-injectable like the scheduler: the host feeds
    every pulled artifact frame to ``on_message`` together with a
    ``push(client_id, msg)`` callable, and calls ``tick(push)`` once per
    poll so stale compile/relay assignments expire.
    """

    def __init__(self, mode: str = "serve", *,
                 max_bytes: int = 256 << 20,
                 chunk_bytes: int = 1 << 20,
                 pending_timeout_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.max_bytes = max_bytes
        self.chunk_bytes = chunk_bytes
        self.pending_timeout_s = pending_timeout_s
        self.clock = clock
        self._blobs: "OrderedDict[str, bytes]" = OrderedDict()
        self._blob_bytes = 0
        self.residency: Dict[str, Set[int]] = {}
        self._fp_addr: Dict[str, str] = {}      # repr(cache_key) -> addr
        # addr -> {"kind": "compile"|"relay", "client": cid,
        #          "deadline": t, "waiters": [cid, ...]}
        self._pending: Dict[str, dict] = {}
        self._rx = ChunkAssembler()
        self.n_hits = 0          # queries served (directly or via relay)
        self.n_misses = 0        # queries that assigned a compiler
        self.n_waits = 0         # queries parked behind an in-flight compile
        self.n_relays = 0        # fetches relayed to a resident peer
        self.n_puts = 0          # PUT frames absorbed (blob or announcement)
        self.n_gone = 0          # relayed fetches that came back empty
        self.n_expired = 0       # pending assignments that timed out
        self.n_evictions = 0     # serve-mode blob-cache LRU evictions
        self.served_bytes = 0    # blob bytes pushed to clients
        # multi-tenant attribution hook: client_id -> tenant name (or None).
        # ExploreService installs one (the tenant of the client's running
        # chunk); the per-tenant served/assigned splits feed
        # launch.report.cache_effectiveness
        self.tenant_fn: Optional[Callable[[int], Optional[str]]] = None
        self.tenant_hits: Dict[str, int] = {}    # queries served, per tenant
        self.tenant_misses: Dict[str, int] = {}  # compiles assigned, per tenant

    # -- residency (the fleet-global CacheShadow generalization) ------------
    def resident_fp(self, fp: str) -> bool:
        """Can the fleet satisfy this fingerprint without a compile?

        True when the blob is host-cached, a client holds it (relayable),
        or its compile is already assigned — in every case a chunk homed on
        a *different* client costs a fetch, not a fresh compile, so
        affinity dispatch treats the group as a free rider.
        """
        addr = self._fp_addr.get(fp)
        if addr is None:
            return False
        return (addr in self._blobs or bool(self.residency.get(addr))
                or addr in self._pending)

    def resident_addrs(self) -> Set[str]:
        out = set(a for a, cids in self.residency.items() if cids)
        out.update(self._blobs)
        return out

    def _attr(self, table: Dict[str, int], cid) -> None:
        """Charge one hit/miss to the tenant the client is working for."""
        if self.tenant_fn is None or not isinstance(cid, int):
            return
        try:
            tenant = self.tenant_fn(cid)
        except Exception:
            return          # attribution must never take the store down
        if tenant:
            table[tenant] = table.get(tenant, 0) + 1

    # -- message pump -------------------------------------------------------
    @staticmethod
    def is_artifact_msg(msg) -> bool:
        return is_artifact_msg(msg)

    def on_message(self, msg: dict, push: Callable[[int, dict], None]) -> None:
        cmd = msg.get("cmd")
        if cmd == ARTIFACT_CHUNK:
            done = self._rx.feed(msg)
            if done is None:
                return
            msg, cmd = done, ARTIFACT_PUT
        if cmd == ARTIFACT_QUERY:
            self._on_query(msg, push)
        elif cmd == ARTIFACT_PUT:
            self._on_put(msg, push)
        # FETCH/MISS are host→client only; ignore echoes

    def _on_query(self, msg: dict, push) -> None:
        cid, addr = msg.get("client_id"), msg.get("addr")
        if not isinstance(cid, int) or not isinstance(addr, str):
            return
        self._note_fp(msg)
        spec = bool(msg.get("spec"))
        if addr in self._blobs:                       # host-cached: serve now
            self.n_hits += 1
            self._attr(self.tenant_hits, cid)
            self._serve(cid, addr, push)
            return
        pend = self._pending.get(addr)
        if spec:
            # passive prefetch (one wave per incoming batch): serve what
            # exists, join the waiter list of an in-flight compile/relay,
            # but NEVER assign compile duty — a wave landing first would
            # otherwise pile several fingerprints' compiles onto one
            # client.  Always answer (spec MISS) so the collect loop is
            # never parked behind a compile.
            if pend is not None and cid != pend["client"] \
                    and cid not in pend["waiters"]:
                pend["waiters"].append(cid)
                self.n_waits += 1
            elif pend is None and self.mode == "relay":
                peers = [c for c in sorted(self.residency.get(addr, ()))
                         if c != cid]
                if peers:
                    self.n_relays += 1
                    self.n_hits += 1
                    self._attr(self.tenant_hits, cid)
                    push(peers[0], {"cmd": ARTIFACT_FETCH, "addr": addr,
                                    "fp": msg.get("fp")})
                    self._pending[addr] = {
                        "kind": "relay", "client": peers[0],
                        "deadline": self.clock() + self.pending_timeout_s,
                        "waiters": [cid]}
            push(cid, {"cmd": ARTIFACT_MISS, "addr": addr, "spec": True})
            return
        if pend is not None:                          # compile/relay in flight
            if cid == pend["client"] and pend["kind"] == "compile":
                # the designated compiler asked again (e.g. after a timed-out
                # wait): re-confirm the assignment so it never stalls
                push(cid, {"cmd": ARTIFACT_MISS, "addr": addr})
            elif cid != pend["client"] and cid not in pend["waiters"]:
                pend["waiters"].append(cid)
                self.n_waits += 1
            return
        peers = [c for c in sorted(self.residency.get(addr, ()))
                 if c != cid]
        if self.mode == "relay" and peers:
            self.n_relays += 1
            self.n_hits += 1
            self._attr(self.tenant_hits, cid)
            push(peers[0], {"cmd": ARTIFACT_FETCH, "addr": addr,
                            "fp": msg.get("fp")})
            self._pending[addr] = {
                "kind": "relay", "client": peers[0],
                "deadline": self.clock() + self.pending_timeout_s,
                "waiters": [cid]}
            return
        # nothing in the fleet: the asker becomes the designated compiler
        self.n_misses += 1
        self._attr(self.tenant_misses, cid)
        self._pending[addr] = {
            "kind": "compile", "client": cid,
            "deadline": self.clock() + self.pending_timeout_s,
            "waiters": []}
        push(cid, {"cmd": ARTIFACT_MISS, "addr": addr})

    def _on_put(self, msg: dict, push) -> None:
        cid, addr = msg.get("client_id"), msg.get("addr")
        if not isinstance(addr, str):
            return
        self._note_fp(msg)
        self.n_puts += 1
        if msg.get("status") == "gone":
            # the relayed peer no longer holds it (LRU'd out and no disk):
            # drop its residency claim and fail the waiters over to compile
            self.n_gone += 1
            if isinstance(cid, int):
                self.residency.get(addr, set()).discard(cid)
            self._fail_pending(addr, push)
            return
        if isinstance(cid, int):
            self.residency.setdefault(addr, set()).add(cid)
        blob = msg.get("blob")
        pend = self._pending.pop(addr, None)
        if isinstance(blob, (bytes, bytearray)):
            blob = bytes(blob)
            if self.mode == "serve":
                self._store_blob(addr, blob)
            waiters = pend["waiters"] if pend else []
            for w in waiters:
                self.n_hits += 1
                self._attr(self.tenant_hits, w)
                self._push_blob(w, addr, blob, push)
            return
        # blob-less residency announcement (relay mode): waiters parked on
        # the compile are relayed to the now-resident compiler
        if pend and pend["waiters"] and isinstance(cid, int):
            self.n_relays += 1
            push(cid, {"cmd": ARTIFACT_FETCH, "addr": addr,
                       "fp": msg.get("fp")})
            self._pending[addr] = {
                "kind": "relay", "client": cid,
                "deadline": self.clock() + self.pending_timeout_s,
                "waiters": list(pend["waiters"])}

    # -- maintenance --------------------------------------------------------
    def tick(self, push: Callable[[int, dict], None]) -> None:
        """Expire stale compile/relay assignments (dead designated clients
        must not park waiters forever)."""
        now = self.clock()
        for addr in [a for a, p in self._pending.items()
                     if now > p["deadline"]]:
            self.n_expired += 1
            self._fail_pending(addr, push)

    def _fail_pending(self, addr: str, push) -> None:
        pend = self._pending.pop(addr, None)
        if pend is None:
            return
        for w in pend["waiters"]:
            try:
                push(w, {"cmd": ARTIFACT_MISS, "addr": addr})
            except Exception:
                pass

    # -- blob cache (serve mode) -------------------------------------------
    def _store_blob(self, addr: str, blob: bytes) -> None:
        old = self._blobs.pop(addr, None)
        if old is not None:
            self._blob_bytes -= len(old)
        self._blobs[addr] = blob
        self._blob_bytes += len(blob)
        while self._blob_bytes > self.max_bytes and len(self._blobs) > 1:
            _, dropped = self._blobs.popitem(last=False)
            self._blob_bytes -= len(dropped)
            self.n_evictions += 1

    def _serve(self, cid: int, addr: str, push) -> None:
        blob = self._blobs[addr]
        self._blobs.move_to_end(addr)                 # LRU touch
        self._push_blob(cid, addr, blob, push)

    def _push_blob(self, cid: int, addr: str, blob: bytes, push) -> None:
        self.served_bytes += len(blob)
        self.residency.setdefault(addr, set()).add(cid)  # it will hold it
        base = {"addr": addr}
        for frame in chunk_blob(base, blob, self.chunk_bytes):
            push(cid, frame)

    # -- introspection ------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "fleet_mode": self.mode,
            "fleet_hits": self.n_hits,
            "fleet_misses": self.n_misses,
            "fleet_waits": self.n_waits,
            "fleet_relays": self.n_relays,
            "fleet_puts": self.n_puts,
            "fleet_gone": self.n_gone,
            "fleet_expired": self.n_expired,
            "fleet_blobs": len(self._blobs),
            "fleet_blob_mb": round(self._blob_bytes / 1e6, 6),
            "fleet_evictions": self.n_evictions,
            "fleet_served_mb": round(self.served_bytes / 1e6, 6),
            "fleet_resident_addrs": len(self.resident_addrs()),
            "fleet_pending": len(self._pending),
        }
        if self.tenant_hits or self.tenant_misses:
            out["fleet_tenant_hits"] = dict(self.tenant_hits)
            out["fleet_tenant_misses"] = dict(self.tenant_misses)
        return out

    def _note_fp(self, msg: dict) -> None:
        fp, addr = msg.get("fp"), msg.get("addr")
        if isinstance(fp, str) and isinstance(addr, str):
            self._fp_addr[fp] = addr
