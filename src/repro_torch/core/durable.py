"""Durable exploration: atomic sweep snapshots plus a write-ahead event log.

A copy of ``repro/core/durable.py``.

``JHost.explore(checkpoint_dir=...)`` journals every searcher interaction to
an append-only JSONL event log (``events.jsonl``, flushed per record, torn-
tail tolerant) and periodically snapshots the full sweep state — searcher
archive/RNG via ``state_dict()``, the outstanding (asked-but-uncompleted)
config ids with their knobs, and the config-id counter — with the same
atomic write-temp-rename / keep-k / async-writer pattern proven in
the reference's ``repro/train/checkpoint.py`` (jax-free here: one pickle blob per
snapshot, pickled synchronously on the caller's thread so live state can
keep mutating while the writer thread flushes).

Resume = latest snapshot + replay of the log suffix:

* ``ask`` events re-invoke ``search.ask(n)`` so a deterministic searcher
  advances its RNG/GP/seen-set exactly as the crashed run did — fold-block
  boundaries included, which is what makes the resumed pick sequence
  bit-identical.  The *logged* knobs stay authoritative for what actually
  got dispatched; a mismatch is counted, not fatal, because an async
  ``SearchDriver`` resume is correct-but-not-bit-identical (its fold
  boundaries depend on worker timing).
* ``tell`` events re-apply observations in the original fold order.
* The re-adopted CSV is the results ledger: completed config ids are
  subtracted from the outstanding set (nothing is evaluated twice), ok rows
  whose ``tell`` never reached the log — the host died between the CSV
  flush and the log append — are told now, and whatever is left is
  re-submitted under its original config id.

With no snapshot yet the whole log replays against the freshly constructed
searcher, so a sweep is resumable from its very first event; snapshots just
truncate the replay.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np

_SNAP_RE = re.compile(r"snap_(\d+)\.pkl$")


class ExplorationCheckpoint:
    """Snapshot + write-ahead event log for one exploration sweep.

    Layout::

        <dir>/snap_<seq>.pkl   atomic (.tmp + rename), keep-k GC'd
        <dir>/events.jsonl     append-only, flushed per record

    The event log survives across resumes (positions are absolute file
    offsets, so a snapshot's ``event_pos`` stays valid after appends); a
    tail torn by a mid-write kill is truncated on ``open_log()``.
    """

    EVENTS = "events.jsonl"

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self.events_path = os.path.join(directory, self.EVENTS)
        self._events_f = None
        existing = self.all_seqs()
        self._seq = existing[-1] if existing else 0

    # -- event log -----------------------------------------------------------
    def open_log(self) -> int:
        """Repair a torn tail, open the log for append; returns its size."""
        pos = self._repair_tail()
        self._events_f = open(self.events_path, "a", encoding="utf-8")
        return pos

    def _repair_tail(self) -> int:
        try:
            with open(self.events_path, "rb") as f:
                data = f.read()
        except OSError:
            return 0
        good = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break
            try:
                json.loads(line)
            except ValueError:
                break
            good += len(line)
        if good != len(data):
            print(f"# checkpoint: truncated torn event-log tail "
                  f"({len(data) - good} bytes)")
            with open(self.events_path, "r+b") as f:
                f.truncate(good)
        return good

    def log_pos(self) -> int:
        return self._events_f.tell() if self._events_f is not None else 0

    def log_ask(self, ids: List[int], knobs_list: List[dict]) -> None:
        self._log({"t": "ask", "ids": list(ids), "knobs": list(knobs_list)})

    def log_tell(self, config_id: int, knobs: dict, y) -> None:
        self._log({"t": "tell", "id": int(config_id), "knobs": knobs,
                   "y": [float(v) for v in np.asarray(y).ravel()]})

    def _log(self, rec: dict) -> None:
        if self._events_f is None:
            raise RuntimeError("event log not open — call open_log() first")
        self._events_f.write(json.dumps(rec) + "\n")
        # flush reaches the kernel: a kill -9 after this point cannot lose
        # the event (only power loss could, which is out of contract)
        self._events_f.flush()

    def read_events(self, from_pos: int = 0) -> List[dict]:
        """Events at offsets ≥ from_pos; stops at the first torn line."""
        out: List[dict] = []
        try:
            f = open(self.events_path, "rb")
        except OSError:
            return out
        with f:
            f.seek(from_pos)
            for line in f:
                if not line.endswith(b"\n"):
                    break
                try:
                    out.append(json.loads(line))
                except ValueError:
                    break
        return out

    # -- snapshots -------------------------------------------------------------
    def save(self, payload: Dict[str, Any], block: bool = False) -> None:
        """Atomically publish a snapshot (pickled now, written async)."""
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        self.wait()
        self._seq += 1
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(self._seq, blob), daemon=True)
            self._thread.start()
        else:
            self._write(self._seq, blob)

    def _write(self, seq: int, blob: bytes) -> None:
        final = os.path.join(self.directory, f"snap_{seq:08d}.pkl")
        tmp = os.path.join(self.directory, f".tmp-snap_{seq:08d}.pkl")
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, final)   # atomic publish: no torn snapshot exists
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_seqs()[:-self.keep] if self.keep else []:
            try:
                os.remove(os.path.join(self.directory, f"snap_{s:08d}.pkl"))
            except OSError:
                pass

    def all_seqs(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _SNAP_RE.fullmatch(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[Dict[str, Any]]:
        """Newest loadable snapshot payload (skips unreadable ones)."""
        for s in reversed(self.all_seqs()):
            path = os.path.join(self.directory, f"snap_{s:08d}.pkl")
            try:
                with open(path, "rb") as f:
                    return pickle.load(f)
            except Exception as e:
                print(f"# checkpoint: skipping unreadable {path}: {e}")
        return None

    def close(self) -> None:
        self.wait()
        if self._events_f is not None:
            self._events_f.close()
            self._events_f = None


def restore_sweep(ckpt: ExplorationCheckpoint, search, store,
                  objectives) -> Dict[str, Any]:
    """Rebuild searcher + outstanding-work state for a resumed sweep.

    ``store`` must already hold the re-adopted CSV records
    (``ResultStore.resume_from_csv``).  Returns a dict with ``outstanding``
    ({config_id: knobs} to re-submit), ``next_id`` (config-id counter), and
    replay stats.  Call *before* ``ckpt.open_log()`` so the torn-tail repair
    and the replay read see the same bytes.
    """
    snap = ckpt.latest()
    ckpt._repair_tail()
    outstanding: Dict[int, dict] = {}
    next_id, pos = 0, 0
    if snap is not None and snap.get("search_state") is not None \
            and hasattr(search, "load_state"):
        search.load_state(snap["search_state"])
        pos = snap["event_pos"]
        outstanding = {int(k): v for k, v in snap["outstanding"]}
        next_id = snap["next_id"]
    events = ckpt.read_events(pos)
    told = set()
    n_ask_mismatch = 0
    for ev in events:
        if ev["t"] == "ask":
            ids, knobs = ev["ids"], ev["knobs"]
            try:
                picks = list(search.ask(len(ids)))
            except Exception as e:
                print(f"# checkpoint: replay ask({len(ids)}) failed ({e}); "
                      f"using logged knobs")
                picks = []
            if picks != list(knobs):
                n_ask_mismatch += 1
            for cid, kn in zip(ids, knobs):
                outstanding[int(cid)] = kn
            if ids:
                next_id = max(next_id, max(ids) + 1)
        elif ev["t"] == "tell":
            search.tell(ev["knobs"], np.asarray(ev["y"], dtype=float))
            told.add(int(ev["id"]))
            outstanding.pop(int(ev["id"]), None)
    # reconcile against the results ledger: a completed id never runs again;
    # an ok row whose tell never reached the log is told now, in CSV order
    n_late_tells = 0
    for rec in store.records:
        cid = rec.config_id
        if cid in outstanding:
            if rec.status == "ok" and cid not in told:
                search.tell(outstanding[cid],
                            np.asarray([rec.metrics[k] for k in objectives],
                                       dtype=float))
                n_late_tells += 1
            del outstanding[cid]
        next_id = max(next_id, cid + 1)
    return {"outstanding": outstanding, "next_id": next_id,
            "n_events": len(events), "n_late_tells": n_late_tells,
            "n_ask_mismatch": n_ask_mismatch,
            "from_snapshot": snap is not None}


def tenant_checkpoint_dir(root: str, tenant: str) -> str:
    """Per-tenant checkpoint namespace under a service-wide root.

    Each tenant of an ``ExploreService`` checkpoints into its own
    subdirectory, so its snapshot sequence and WAL look exactly like a solo
    sweep's — a sweep checkpointed under the service resumes solo (and vice
    versa) with no translation.  Tenant names are sanitized to a safe
    filesystem slug; distinct names that collide after sanitization are
    disambiguated with a short hash suffix.
    """
    slug = re.sub(r"[^A-Za-z0-9._-]+", "_", tenant) or "_"
    if slug != tenant:
        import hashlib

        slug += "-" + hashlib.sha256(tenant.encode()).hexdigest()[:8]
    return os.path.join(root, slug)
