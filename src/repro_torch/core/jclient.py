"""JClient — the device-side worker (paper §III, Algorithm 1).

A copy of ``repro/core/jclient.py``, fleet tier included.

Capabilities, mirroring the paper:
  1. configure the device + workload from a received testConfig (JConfig);
  2. measure (JMeasure set, enable/disable at construction);
  3. communicate with the host (any ClientTransport).

The workload is injected as ``build_fn(TestConfig) -> (Artifact, meta)`` —
"the workloads can be anything as JExplore is agnostic to the workload".
Compiled artifacts are cached by the sw-knob fingerprint, the analogue of the
network staying resident on a Jetson while only clocks change.  The cache is
a true LRU: a hit refreshes the key, so hot sw-points survive long sweeps
that touch more unique fingerprints than ``cache_size``.

Persistent artifact cache (``cache_dir``)
-----------------------------------------
With ``cache_dir`` set, the in-memory LRU becomes the *hot tier* of a
two-tier cache: every freshly built ``BuildResult`` is also pickled to disk,
content-addressed, and an in-memory miss tries the disk tier before calling
``build_fn`` — the analogue of an on-disk TensorRT engine cache, so a
restarted client (or a repeated sweep) skips the compile entirely for every
fingerprint it has ever built.

Layout: ``<cache_dir>/<hh>/<hash>.pkl`` where ``hash`` is the SHA-256 of
``repr((JConfig.identity(), cache_key))`` and ``hh`` its first two hex
chars (keeps directories small on big sweeps).  Each file holds
``{"v": _DISK_CACHE_VERSION, "key": repr(cache_key), "built": BuildResult}``
written atomically: the payload goes to a uniquely-suffixed temp file
(mkstemp + pid suffix, so two processes sharing one ``--cache-dir`` can
never interleave into one temp file) and lands via ``os.replace``.
Readers therefore never see a torn file on a POSIX filesystem; on
filesystems with weaker rename semantics (NFS) an unreadable read is
retried once after a short sleep — the concurrent writer has usually
finished by then — and only then counted as a miss.

Fleet tier (``fleet_mode``)
---------------------------
With ``fleet_mode`` set (``"serve"`` | ``"relay"``) and a transport
attached, a miss in *both* local tiers asks the fleet before compiling:
the client pushes an ``ARTIFACT_QUERY`` (same content address as the disk
tier) up its result socket and briefly blocks for the host's reply —
a pickled ``BuildResult`` blob from a peer (hit: unpickle, adopt into both
local tiers), or ``ARTIFACT_MISS`` (this client is now the fingerprint's
designated compiler — build, then announce).  In ``serve`` mode the
announcement carries the blob (the host caches and serves it); in
``relay`` mode it is residency-only and the host relays an
``ARTIFACT_FETCH`` back here when a peer needs it.  Config frames that
arrive while the client waits are backlogged and evaluated afterwards, so
the fleet wait never drops work.  See ``repro_torch.core.fleet``.

Invalidation rules: the address covers everything that determines the
artifact — the jconfig identity (design-space knob names/values/kinds +
``n_chips``) and the full ``cache_key`` (arch, shape, sw-knob values) — so
changing any of those naturally misses.  What the address *cannot* see is
the body of ``build_fn`` itself: if the workload builder changes
behaviourally, bump ``_DISK_CACHE_VERSION`` or delete the directory.  A
corrupt/unreadable/version-mismatched file is treated as a miss and
overwritten; entries are never aged out automatically.

``cache_info()`` reports both tiers, and ``serve`` attaches the summary to
every chunk reply (one ``cache_info`` sidecar per result frame) — the
host's ``DispatchScheduler`` uses it to keep its per-client cache shadow
honest for compile-affinity placement.

Batched fast path (group-by-compile)
------------------------------------
``evaluate_batch`` is the throughput-oriented entry point.  It groups the
incoming configs by their sw-knob fingerprint (``JConfig.cache_key``),
compiles each unique sw-group **once**, then sweeps every hw-knob variant of
the group through the vectorized measurement path
(``JMeasure.measure_batch`` over an ``HwModelBatch`` of ``(N,)`` ladder
arrays).  Compile work is therefore O(unique sw-points) instead of
O(configs), and per-config Python/dict overhead collapses into a handful of
numpy sweeps — metrics stay bit-identical to the scalar ``evaluate`` path.
``serve`` speaks both wire formats: a plain testConfig message is evaluated
scalar; a ``{"cmd": "batch", "items": [...]}`` frame (see transport.py) runs
``evaluate_batch`` and pushes one batched result frame back.  Under a
double-buffering host (``dispatch="pipelined"``) several chunks may already
be sitting in the transport queue when the client wakes up — ``serve``
drains every queued batch frame first and coalesces them into a **single**
``evaluate_batch`` call, so speculative chunks share one group-by-compile
sweep and come back as one result frame.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.jconfig import JConfig, TestConfig
from repro_torch.core.jmeasure import DEFAULT_MEASURES, JMeasure
from repro_torch.core.transport import (ARTIFACT_CHUNK, ARTIFACT_CMDS,
                                  ARTIFACT_FETCH, ARTIFACT_MISS,
                                  ARTIFACT_PUT, ARTIFACT_QUERY, BATCH_CMD,
                                  BATCH_COLS_CMD, CLIENT_GOODBYE,
                                  CLIENT_HELLO, ChunkAssembler,
                                  ClientTransport, chunk_blob, unframe_batch)
from repro_torch.roofline.analysis import Artifact

BuildResult = Tuple[Artifact, Dict]

# bump when BuildResult semantics change behaviourally for the same address
# (the content hash cannot see the body of build_fn)
_DISK_CACHE_VERSION = 1

_FLEET_MODES = (None, "serve", "relay")


class JClient:
    def __init__(self, jconfig: JConfig,
                 build_fn: Callable[[TestConfig], BuildResult],
                 measures: Sequence[JMeasure] = DEFAULT_MEASURES,
                 transport: Optional[ClientTransport] = None,
                 client_id: int = 0,
                 cache_size: int = 64,
                 cache_dir: Optional[str] = None,
                 fleet_mode: Optional[str] = None,
                 fleet_timeout_s: float = 30.0,
                 fleet_chunk_bytes: int = 1 << 20):
        if fleet_mode not in _FLEET_MODES:
            raise ValueError(f"fleet_mode must be one of {_FLEET_MODES}, "
                             f"got {fleet_mode!r}")
        self.jconfig = jconfig
        self.build_fn = build_fn
        self.measures = tuple(measures)
        self.transport = transport
        self.client_id = client_id
        self._cache: Dict[tuple, BuildResult] = {}
        self._cache_size = cache_size
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self.cache_dir = cache_dir
        self._disk_hits = 0
        self._disk_misses = 0
        self._disk_stores = 0
        self.fleet_mode = fleet_mode
        self.fleet_timeout_s = fleet_timeout_s
        self.fleet_chunk_bytes = fleet_chunk_bytes
        self._fleet_hits = 0
        self._fleet_misses = 0
        self._fleet_puts = 0
        self._fleet_bytes_in = 0
        self._fleet_bytes_out = 0
        self._fleet_rx = ChunkAssembler()
        self._addr_key: Dict[str, tuple] = {}   # content addr -> cache_key
        self._rx_backlog: List[dict] = []       # frames deferred by a wait
        # keys a prefetch wave already got ARTIFACT_MISS for: this client
        # is their designated compiler, _artifact must not re-query
        self._fleet_skip: set = set()
        self.n_evaluated = 0
        self.n_compiled = 0
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)

    # -- persistent tier (content-addressed pickles, see module docstring) ----
    def _addr(self, key: tuple) -> str:
        """Content address shared by the disk tier and the fleet store."""
        return hashlib.sha256(
            repr((self.jconfig.identity(), key)).encode("utf-8")).hexdigest()

    def _disk_path(self, key: tuple) -> str:
        h = self._addr(key)
        return os.path.join(self.cache_dir, h[:2], h + ".pkl")

    def _disk_load(self, key: tuple) -> Optional[BuildResult]:
        """Read-validate a disk entry; an unreadable file is retried once.

        A concurrent writer sharing this ``cache_dir`` can expose a torn
        or mid-rename read on filesystems without atomic-replace semantics;
        by the retry (5 ms later) the replace has almost always landed.  A
        *cleanly* read entry that fails validation (version bump, hash
        collision) is a deterministic miss — no retry.
        """
        path = self._disk_path(key)
        for attempt in (0, 1):
            try:
                with open(path, "rb") as f:
                    payload = pickle.load(f)
            except FileNotFoundError:
                return None               # plain miss
            except Exception:
                if attempt == 0:          # torn read: writer mid-flight?
                    time.sleep(0.005)
                    continue
                return None
            if (isinstance(payload, dict)
                    and payload.get("v") == _DISK_CACHE_VERSION
                    and payload.get("key") == repr(key)):
                return payload["built"]
            return None
        return None

    def _disk_store(self, key: tuple, built: BuildResult) -> None:
        """Best-effort atomic write; an unpicklable artifact (live device
        buffers, etc.) simply stays memory-only.  The tmp name comes from
        mkstemp *plus a pid suffix*: unique per process and per call, so
        concurrent writers — threads in one process or separate processes
        sharing one ``--cache-dir`` — can never interleave into one file,
        and a crashed writer's orphan is identifiable."""
        path = self._disk_path(key)
        tmp = None
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       suffix=f".{os.getpid()}.tmp")
            with os.fdopen(fd, "wb") as f:
                pickle.dump({"v": _DISK_CACHE_VERSION, "key": repr(key),
                             "built": built}, f)
            os.replace(tmp, path)
            self._disk_stores += 1
        except Exception:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # -- artifact cache (LRU hot tier keyed by sw fingerprint) ----------------
    def _artifact(self, key: tuple, tc: TestConfig) -> BuildResult:
        if key in self._cache:
            self._cache[key] = self._cache.pop(key)  # refresh: true LRU
            self._cache_hits += 1
            return self._cache[key]
        self._cache_misses += 1
        built = None
        if self.cache_dir is not None:
            built = self._disk_load(key)
            if built is not None:
                self._disk_hits += 1
            else:
                self._disk_misses += 1
        fetched = False
        if built is None and self.fleet_mode is not None \
                and self.transport is not None:
            if key in self._fleet_skip:
                # a prefetch wave already asked and this client was made
                # the designated compiler (miss counted there): build
                self._fleet_skip.discard(key)
            else:
                built = self._fleet_fetch(key)
                fetched = built is not None
                if fetched:
                    self._fleet_hits += 1
                else:
                    self._fleet_misses += 1
        if built is None:
            built = self.build_fn(tc)
            self.n_compiled += 1
            if self.cache_dir is not None:
                self._disk_store(key, built)
            if self.fleet_mode is not None and self.transport is not None:
                self._fleet_announce(key, built)
        elif fetched and self.cache_dir is not None:
            self._disk_store(key, built)    # adopt the peer's blob locally
        self._cache_insert(key, built)
        return built

    def _cache_insert(self, key: tuple, built: BuildResult) -> None:
        if key in self._cache:
            self._cache[key] = self._cache.pop(key)
            return
        if len(self._cache) >= self._cache_size:
            self._cache.pop(next(iter(self._cache)))  # least-recently used
            self._cache_evictions += 1
        self._cache[key] = built

    def cache_info(self) -> Dict[str, int]:
        """functools-style counters for the artifact cache, all tiers."""
        info = {"hits": self._cache_hits, "misses": self._cache_misses,
                "evictions": self._cache_evictions,
                "currsize": len(self._cache), "maxsize": self._cache_size}
        if self.cache_dir is not None:
            info.update({"disk_hits": self._disk_hits,
                         "disk_misses": self._disk_misses,
                         "disk_stores": self._disk_stores})
        if self.fleet_mode is not None:
            info.update({"fleet_hits": self._fleet_hits,
                         "fleet_misses": self._fleet_misses,
                         "fleet_puts": self._fleet_puts,
                         "fleet_bytes_in": self._fleet_bytes_in,
                         "fleet_bytes_out": self._fleet_bytes_out})
        return info

    # -- fleet tier (host-mediated peer cache, see repro_torch.core.fleet) ----------
    def _payload_blob(self, key: tuple, built: BuildResult) -> Optional[bytes]:
        """The disk-tier payload, pickled — the unit the fleet moves."""
        try:
            return pickle.dumps({"v": _DISK_CACHE_VERSION, "key": repr(key),
                                 "built": built})
        except Exception:
            return None       # live device buffers etc.: memory-only

    def _accept_blob(self, key: tuple, msg: dict) -> Optional[BuildResult]:
        blob = msg.get("blob")
        if not isinstance(blob, (bytes, bytearray)):
            return None
        self._fleet_bytes_in += len(blob)
        try:
            payload = pickle.loads(bytes(blob))
        except Exception:
            return None
        if (isinstance(payload, dict)
                and payload.get("v") == _DISK_CACHE_VERSION
                and payload.get("key") == repr(key)):
            return payload["built"]
        return None

    def _fleet_fetch(self, key: tuple) -> Optional[BuildResult]:
        """Query the host for a peer's artifact; block up to
        ``fleet_timeout_s`` for the verdict.  Any non-matching frame pulled
        while waiting (queued config chunks, other artifact traffic) is
        backlogged for ``serve`` to process afterwards — the wait never
        drops work."""
        addr = self._addr(key)
        self._addr_key[addr] = key
        try:
            self.transport.push({"cmd": ARTIFACT_QUERY, "addr": addr,
                                 "fp": repr(key),
                                 "client_id": self.client_id})
        except Exception:
            return None
        deadline = time.monotonic() + self.fleet_timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            msg = self.transport.pull(min(remaining, 0.05))
            if msg is None:
                continue
            cmd = msg.get("cmd")
            if cmd == ARTIFACT_CHUNK and msg.get("addr") == addr:
                done = self._fleet_rx.feed(msg)
                if done is None:
                    continue
                msg, cmd = done, ARTIFACT_PUT
            if cmd == ARTIFACT_PUT and msg.get("addr") == addr:
                return self._accept_blob(key, msg)
            if cmd == ARTIFACT_MISS and msg.get("addr") == addr:
                if msg.get("spec"):
                    continue      # stale passive reply: not an assignment
                return None       # this client is the designated compiler
            if cmd in ARTIFACT_CMDS:
                # other artifact traffic is handled INLINE, not backlogged:
                # a relayed ARTIFACT_FETCH for an artifact this client holds
                # must be answered now — two clients each waiting on a blob
                # the other one holds would otherwise deadlock until their
                # fleet timeouts (serving a fetch only reads local tiers,
                # so it cannot recurse into another fleet wait)
                self._on_artifact(msg)
                continue
            self._rx_backlog.append(msg)

    def _fleet_prefetch(self, keys: Sequence[tuple]) -> None:
        """Pipeline fleet queries for every fingerprint an incoming batch
        needs but no local tier holds: one wave of ``ARTIFACT_QUERY``s,
        then one collect loop — k fetches cost ~one host round trip
        instead of k serial ones.

        Prefetch queries are *passive* (``spec: True``): the host serves a
        cached blob or parks us in a waiter list, but never assigns
        compile duty (that would pile several fingerprints' compiles onto
        whichever client's wave lands first) and always answers at once —
        a ``spec`` MISS means "nothing to serve yet, move on", after which
        the per-group ``_fleet_fetch`` does the active query.  Blobs that
        arrive after the wave (an in-flight compile we joined as waiter)
        are adopted by ``_on_artifact``.
        """
        want: Dict[str, tuple] = {}
        for key in keys:
            if key in self._cache or key in self._fleet_skip:
                continue
            if self.cache_dir is not None \
                    and os.path.exists(self._disk_path(key)):
                continue                   # the disk tier will hit
            addr = self._addr(key)
            self._addr_key[addr] = key
            want[addr] = key
        if not want:
            return
        try:
            for addr, key in want.items():
                self.transport.push({"cmd": ARTIFACT_QUERY, "addr": addr,
                                     "fp": repr(key), "spec": True,
                                     "client_id": self.client_id})
        except Exception:
            return
        outstanding = set(want)
        deadline = time.monotonic() + self.fleet_timeout_s
        while outstanding:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            msg = self.transport.pull(min(remaining, 0.05))
            if msg is None:
                continue
            cmd = msg.get("cmd")
            addr = msg.get("addr")
            if cmd == ARTIFACT_CHUNK and addr in outstanding:
                done = self._fleet_rx.feed(msg)
                if done is None:
                    continue
                msg, cmd = done, ARTIFACT_PUT
            if cmd == ARTIFACT_PUT and addr in outstanding:
                outstanding.discard(addr)
                key = want[addr]
                built = self._accept_blob(key, msg)
                if built is not None:
                    self._fleet_hits += 1
                    if self.cache_dir is not None:
                        self._disk_store(key, built)
                    self._cache_insert(key, built)
            elif cmd == ARTIFACT_MISS and addr in outstanding:
                outstanding.discard(addr)
                if not msg.get("spec"):
                    # a stale *active* MISS: we hold compile duty for it
                    self._fleet_misses += 1
                    self._fleet_skip.add(want[addr])
                    return   # compile duty first; peers are waiting on us
            elif cmd in ARTIFACT_CMDS:
                self._on_artifact(msg)   # incl. relayed fetches: see above
            else:
                self._rx_backlog.append(msg)

    def _fleet_announce(self, key: tuple, built: BuildResult) -> None:
        """Tell the host about a fresh compile: blob attached in ``serve``
        mode, residency-only in ``relay`` mode."""
        addr = self._addr(key)
        self._addr_key[addr] = key
        base = {"addr": addr, "fp": repr(key), "client_id": self.client_id}
        try:
            if self.fleet_mode == "serve":
                blob = self._payload_blob(key, built)
                if blob is None:
                    return
                self._fleet_bytes_out += len(blob)
                for frame in chunk_blob(base, blob, self.fleet_chunk_bytes):
                    self.transport.push(frame)
            else:
                self.transport.push(dict(base, cmd=ARTIFACT_PUT))
            self._fleet_puts += 1
        except Exception:
            pass              # announcements are best-effort

    def _on_artifact(self, msg: dict) -> None:
        """Handle an artifact frame outside a fetch wait: relay-mode fetch
        requests, and late/prefetch PUTs (adopted into the local tiers)."""
        cmd = msg.get("cmd")
        if cmd == ARTIFACT_CHUNK:
            done = self._fleet_rx.feed(msg)
            if done is None:
                return
            msg, cmd = done, ARTIFACT_PUT
        addr = msg.get("addr")
        if cmd == ARTIFACT_FETCH and isinstance(addr, str):
            self._serve_fetch(addr)
        elif cmd == ARTIFACT_PUT and isinstance(addr, str):
            key = self._addr_key.get(addr)
            if key is None or key in self._cache:
                return
            built = self._accept_blob(key, msg)
            if built is not None:
                self._fleet_hits += 1
                if self.cache_dir is not None:
                    self._disk_store(key, built)
                self._cache_insert(key, built)
        # stray ARTIFACT_MISS frames (e.g. after a timed-out wait): ignore

    def _serve_fetch(self, addr: str) -> None:
        """Relay mode: the host asks for a blob this client supposedly
        holds.  Serve it from LRU or disk; apologize with ``gone`` if both
        tiers lost it (the host drops the residency claim)."""
        key = self._addr_key.get(addr)
        built = None
        if key is not None:
            built = self._cache.get(key)
            if built is None and self.cache_dir is not None:
                built = self._disk_load(key)
        blob = self._payload_blob(key, built) if built is not None else None
        base = {"addr": addr, "client_id": self.client_id}
        if key is not None:
            base["fp"] = repr(key)
        try:
            if blob is None:
                self.transport.push(dict(base, cmd=ARTIFACT_PUT,
                                         status="gone"))
                return
            self._fleet_bytes_out += len(blob)
            self._fleet_puts += 1
            for frame in chunk_blob(base, blob, self.fleet_chunk_bytes):
                self.transport.push(frame)
        except Exception:
            pass

    # -- single evaluation -------------------------------------------------
    def evaluate(self, tc: TestConfig) -> dict:
        t0 = time.monotonic()
        key = self.jconfig.cache_key(tc)
        cached = key in self._cache
        try:
            art, meta = self._artifact(key, tc)
            hw = self.jconfig.hw_model(tc.knobs)
            metrics: Dict[str, float] = {}
            for m in self.measures:
                metrics.update(m.measure(art, hw, meta))
            status = "ok"
        except Exception:
            metrics = {}
            status = "failed"
            metrics["error"] = traceback.format_exc(limit=3)
        self.n_evaluated += 1
        return {
            "config_id": tc.config_id,
            "arch": tc.arch,
            "shape": tc.shape,
            "knobs": tc.knobs,
            "metrics": metrics,
            "status": status,
            "client_id": self.client_id,
            "cached": cached,
            "wall_s": time.monotonic() - t0,
        }

    # -- batched evaluation (group-by-compile) --------------------------------
    def evaluate_batch(self, tcs: Sequence[TestConfig]) -> List[dict]:
        """Evaluate a batch with one compile per unique sw fingerprint.

        Result dicts are ordered like ``tcs`` and carry exactly the scalar
        ``evaluate`` schema; metric values are bit-identical to N scalar
        calls (the vectorized sweep mirrors the scalar arithmetic op-for-op).
        """
        results: List[Optional[dict]] = [None] * len(tcs)
        groups: Dict[tuple, List[int]] = {}
        for i, tc in enumerate(tcs):
            groups.setdefault(self.jconfig.cache_key(tc), []).append(i)
        if self.fleet_mode is not None and self.transport is not None:
            self._fleet_prefetch(list(groups))

        for key, idxs in groups.items():
            g0 = time.monotonic()
            was_cached = key in self._cache
            cols: Dict[str, np.ndarray] = {}
            try:
                art, meta = self._artifact(key, tcs[idxs[0]])
                hwb = self.jconfig.hw_model_batch([tcs[i].knobs for i in idxs])
                for m in self.measures:
                    cols.update(m.measure_batch(art, hwb, meta))
            except Exception:
                # scalar-parity fallback: a group-level failure (bad build, or
                # one hw variant tripping a measure) must not fail sibling
                # configs that would survive the scalar path — re-evaluate the
                # group one config at a time
                for i in idxs:
                    results[i] = self.evaluate(tcs[i])
                    self.n_evaluated -= 1   # evaluate() counted it; the batch
                    # total is added once at the end for all of tcs
                continue
            # one C-level tolist per metric column beats N×K .item() calls
            names = list(cols)
            rows = [np.asarray(cols[k]).tolist() for k in names]
            wall = (time.monotonic() - g0) / len(idxs)  # amortized per config
            for j, i in enumerate(idxs):
                tc = tcs[i]
                results[i] = {
                    "config_id": tc.config_id,
                    "arch": tc.arch,
                    "shape": tc.shape,
                    "knobs": tc.knobs,
                    "metrics": {k: col[j] for k, col in zip(names, rows)},
                    "status": "ok",
                    "client_id": self.client_id,
                    # sequential-scalar parity: the group's first config pays
                    # the compile, the rest ride the cache
                    "cached": was_cached or j > 0,
                    "wall_s": wall,
                }
        self.n_evaluated += len(tcs)
        return results  # type: ignore[return-value]

    def _disk_resident_fps(self, limit: int = 4096) -> List[str]:
        """Fingerprint repr strings rehydrated from the persistent tier.

        The disk filenames are opaque content addresses, but every pickle
        payload records ``repr(cache_key)`` for validation — walking the
        tier recovers exactly the strings ``hello()`` needs, so a
        *restarted* board (empty LRU, warm disk) announces its real compile
        residency without a resync round trip.  Unreadable or
        version-mismatched entries are skipped; ``limit`` bounds the walk
        on a huge shared cache dir.
        """
        out: List[str] = []
        if self.cache_dir is None:
            return out
        try:
            names = sorted(
                os.path.join(d, f)
                for d, _, files in os.walk(self.cache_dir)
                for f in files if f.endswith(".pkl"))
        except OSError:
            return out
        for path in names:
            if len(out) >= limit:
                break
            try:
                with open(path, "rb") as f:
                    payload = pickle.load(f)
            except Exception:
                continue                  # torn/foreign file: not residency
            if (isinstance(payload, dict)
                    and payload.get("v") == _DISK_CACHE_VERSION
                    and isinstance(payload.get("key"), str)):
                out.append(payload["key"])
        return out

    # -- dynamic fleet membership ---------------------------------------------
    def hello(self, endpoint: Optional[str] = None) -> None:
        """Announce this client to the host (join mid-run).

        Carries the resident fingerprints of BOTH local cache tiers — the
        in-memory LRU and, after a restart, the fingerprints rehydrated
        from the persistent ``cache_dir`` (see ``_disk_resident_fps``) —
        as repr strings, the wire form the scheduler's ``_fp_by_repr``
        memo reverses, so the new slot's cache shadow — and affinity
        placement — warm immediately; plus the ``cache_info`` sidecar and,
        for ZMQ fleets, the config ``endpoint`` the host must connect its
        PUSH socket to.
        """
        fps = [repr(k) for k in self._cache]
        seen = set(fps)
        for f in self._disk_resident_fps():
            if f not in seen:
                seen.add(f)
                fps.append(f)
        msg = {"cmd": CLIENT_HELLO, "client_id": self.client_id,
               "resident_fps": fps,
               "cache_info": self.cache_info()}
        if endpoint is not None:
            msg["endpoint"] = endpoint
        self.transport.push(msg)

    def goodbye(self, drain: bool = True) -> None:
        """Announce departure.  ``drain=True`` asks the host to let queued
        chunks finish here first (graceful leave); ``drain=False`` hands
        them straight back to the fleet."""
        self.transport.push({"cmd": CLIENT_GOODBYE,
                             "client_id": self.client_id,
                             "drain": bool(drain)})

    # -- Algorithm 1, JCLIENT procedure ---------------------------------------
    def _pull(self, timeout: float) -> Optional[dict]:
        """Transport pull that honours the fleet-wait backlog: frames
        deferred by ``_fleet_fetch`` come back first, in arrival order."""
        if self._rx_backlog:
            return self._rx_backlog.pop(0)
        return self.transport.pull(timeout)

    def _drain_pending(self, first: dict):
        """Coalesce every already-queued batch frame behind ``first``.

        A pipelined host keeps ≥2 chunks in this client's queue; evaluating
        them as one batch shares the group-by-compile sweep.  Returns
        (batch_frames, scalar_msgs, stop_seen) in arrival order.  Artifact
        frames are handled inline (they carry no work to evaluate).
        """
        frames, scalars, stop = [first], [], False
        while True:
            nxt = self._pull(0.0)
            if nxt is None:
                break
            cmd = nxt.get("cmd")
            if cmd == "stop":
                stop = True
                break
            if cmd in (BATCH_CMD, BATCH_COLS_CMD):
                frames.append(nxt)
            elif cmd in ARTIFACT_CMDS:
                self._on_artifact(nxt)
            else:
                scalars.append(nxt)
        return frames, scalars, stop

    def serve(self, poll_s: float = 1.0, idle_limit_s: Optional[float] = None) -> int:
        assert self.transport is not None, "serve() needs a transport"
        served = 0
        idle = 0.0
        while True:
            msg = self._pull(poll_s)
            if msg is None:
                idle += poll_s
                if idle_limit_s is not None and idle >= idle_limit_s:
                    return served
                continue
            idle = 0.0
            if msg.get("cmd") == "stop":
                return served
            if msg.get("cmd") in ARTIFACT_CMDS:
                self._on_artifact(msg)
                continue
            if msg.get("cmd") in (BATCH_CMD, BATCH_COLS_CMD):
                frames, scalars, stop = self._drain_pending(msg)
                tcs = [TestConfig.from_wire(d)
                       for f in frames for d in unframe_batch(f)]
                # slim wire results: the host rehydrates knobs/arch/shape
                # from its in-flight table, so don't echo them back.  The
                # frame carries one cache_info sidecar — the host scheduler
                # resyncs its per-client cache shadow from it
                self.transport.push_many(
                    [{k: v for k, v in r.items()
                      if k not in ("knobs", "arch", "shape")}
                     for r in self.evaluate_batch(tcs)],
                    extra={"cache_info": self.cache_info()})
                served += len(tcs)
                for m in scalars:   # scalar configs drained behind the frames
                    self.transport.push(self.evaluate(TestConfig.from_wire(m)))
                    served += 1
                if stop:
                    return served
                continue
            result = self.evaluate(TestConfig.from_wire(msg))
            self.transport.push(result)
            served += 1
