"""JClient — the device-side worker (paper §III, Algorithm 1).

A copy of ``repro/core/jclient.py`` without its fleet tier
(``fleet_mode``: a peer artifact cache mediated by the host's
``repro/core/fleet.py``), which comes with ROADMAP slice 6; a ``fleet_mode``
other than None raises ``NotImplementedError``.

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
from repro_torch.core.transport import (BATCH_CMD, BATCH_COLS_CMD,
                                        CLIENT_GOODBYE, CLIENT_HELLO,
                                        ClientTransport, unframe_batch)
from repro_torch.roofline.analysis import Artifact

BuildResult = Tuple[Artifact, Dict]

# bump when BuildResult semantics change behaviourally for the same address
# (the content hash cannot see the body of build_fn)
_DISK_CACHE_VERSION = 1


class JClient:
    def __init__(self, jconfig: JConfig,
                 build_fn: Callable[[TestConfig], BuildResult],
                 measures: Sequence[JMeasure] = DEFAULT_MEASURES,
                 transport: Optional[ClientTransport] = None,
                 client_id: int = 0,
                 cache_size: int = 64,
                 cache_dir: Optional[str] = None,
                 fleet_mode: Optional[str] = None):
        if fleet_mode is not None:
            raise NotImplementedError(
                "the fleet artifact tier is not ported yet (ROADMAP slice 6: "
                "durability, elasticity, service)")
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
        self.n_evaluated = 0
        self.n_compiled = 0
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)

    # -- persistent tier (content-addressed pickles, see module docstring) ----
    def _addr(self, key: tuple) -> str:
        """Content address of the disk tier."""
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
        if built is None:
            built = self.build_fn(tc)
            self.n_compiled += 1
            if self.cache_dir is not None:
                self._disk_store(key, built)
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
        return info

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
    def _drain_pending(self, first: dict):
        """Coalesce every already-queued batch frame behind ``first``.

        A pipelined host keeps ≥2 chunks in this client's queue; evaluating
        them as one batch shares the group-by-compile sweep.  Returns
        (batch_frames, scalar_msgs, stop_seen) in arrival order.
        """
        frames, scalars, stop = [first], [], False
        while True:
            nxt = self.transport.pull(0.0)
            if nxt is None:
                break
            cmd = nxt.get("cmd")
            if cmd == "stop":
                stop = True
                break
            if cmd in (BATCH_CMD, BATCH_COLS_CMD):
                frames.append(nxt)
            else:
                scalars.append(nxt)
        return frames, scalars, stop

    def serve(self, poll_s: float = 1.0, idle_limit_s: Optional[float] = None) -> int:
        assert self.transport is not None, "serve() needs a transport"
        served = 0
        idle = 0.0
        while True:
            msg = self.transport.pull(poll_s)
            if msg is None:
                idle += poll_s
                if idle_limit_s is not None and idle >= idle_limit_s:
                    return served
                continue
            idle = 0.0
            if msg.get("cmd") == "stop":
                return served
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
