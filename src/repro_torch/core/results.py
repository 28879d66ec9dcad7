"""Result store + CSV export + Pareto utilities (paper §III "utility
functions such as saving the explored search space in CSV format").

A copy of ``repro/core/results.py``."""
from __future__ import annotations

import csv
import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ResultRecord:
    config_id: int
    arch: str
    shape: str
    knobs: Dict[str, Any]
    metrics: Dict[str, float]
    status: str = "ok"            # ok | failed | timeout
    client_id: int = -1
    cached: bool = False
    wall_s: float = 0.0

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_wire(d: dict) -> "ResultRecord":
        # drop frame sidecar fields (e.g. cache_info) and anything a newer
        # client may attach: the record schema is the host's contract
        return ResultRecord(**{k: v for k, v in d.items()
                               if k in _RECORD_FIELDS})


_RECORD_FIELDS = frozenset(f.name for f in dataclasses.fields(ResultRecord))


def nondominated_mask(points: np.ndarray) -> np.ndarray:
    """points (N, M), minimisation.  True where no other point dominates.

    One ``(B, N, M)`` broadcast per ≤512-row block (blocked so huge stores
    don't allocate an N² intermediate) instead of a Python loop over rows —
    this sits on the per-ask EHVI hot path.
    """
    points = np.asarray(points)
    n = len(points)
    mask = np.ones(n, bool)
    for lo in range(0, n, 512):
        blk = points[lo:lo + 512]                       # (B, M)
        le = np.all(points[:, None, :] <= blk[None, :, :], axis=2)
        lt = np.any(points[:, None, :] < blk[None, :, :], axis=2)
        mask[lo:lo + 512] = ~np.any(le & lt, axis=0)
    return mask


def _nondominated_mask_loop(points: np.ndarray) -> np.ndarray:
    """Reference per-row implementation (kept for equivalence tests)."""
    n = len(points)
    mask = np.ones(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominates = np.all(points <= points[i], axis=1) & np.any(points < points[i], axis=1)
        if np.any(dominates):
            mask[i] = False
    return mask


class ResultStore:
    """Streaming record sink.

    The CSV schema is the **union** of every knob/metric key seen so far —
    not whatever the first record happened to carry (a leading timeout/failed
    record with empty metrics used to freeze a header without ``metric.*``
    columns, silently dropping every later metric via extrasaction=ignore).
    When a record introduces a new column, the file is rewritten in place
    with the widened header; pre-seed ``knob_names``/``metric_names`` (e.g.
    from the design space + objectives) to avoid rewrites entirely.
    """

    _BASE_FIELDS = ("config_id", "arch", "shape", "status", "client_id",
                    "cached", "wall_s")

    def __init__(self, csv_path: Optional[str] = None,
                 knob_names: Sequence[str] = (),
                 metric_names: Sequence[str] = ()):
        self.records: List[ResultRecord] = []
        self._csv_path = csv_path
        self._lock = threading.Lock()
        self._csv_file = None
        self._csv_writer = None
        self._knob_names = set(knob_names)
        self._metric_names = set(metric_names)
        self._written_rows: List[Dict[str, Any]] = []   # rows on disk

    def add(self, rec: ResultRecord) -> None:
        with self._lock:
            self.records.append(rec)
            if self._csv_path:
                self._append_csv(rec)

    # -- CSV ---------------------------------------------------------------
    def _fieldnames(self) -> List[str]:
        return (list(self._BASE_FIELDS)
                + [f"knob.{k}" for k in sorted(self._knob_names)]
                + [f"metric.{k}" for k in sorted(self._metric_names)])

    def _flatten(self, rec: ResultRecord) -> Dict[str, Any]:
        row = {"config_id": rec.config_id, "arch": rec.arch, "shape": rec.shape,
               "status": rec.status, "client_id": rec.client_id,
               "cached": rec.cached, "wall_s": round(rec.wall_s, 4)}
        row.update({f"knob.{k}": v for k, v in rec.knobs.items()})
        row.update({f"metric.{k}": v for k, v in rec.metrics.items()})
        return row

    def _adopt_existing_csv(self) -> None:
        """Resume-append: fold a pre-existing file's header/rows into ours.

        A host killed mid-``writerow`` leaves a torn trailing line (fewer
        fields than the header, or a dangling overflow column); such rows
        are skipped with a note instead of poisoning the resume-append —
        the first rewrite (widen or first append) drops them from disk too.
        """
        if self._written_rows:
            return      # already writing this file (e.g. re-opened after close)
        if not (os.path.exists(self._csv_path)
                and os.path.getsize(self._csv_path) > 0):
            return
        with open(self._csv_path, newline="") as f:
            reader = csv.DictReader(f)
            for name in reader.fieldnames or []:
                if name.startswith("knob."):
                    self._knob_names.add(name[len("knob."):])
                elif name.startswith("metric."):
                    self._metric_names.add(name[len("metric."):])
            for row in reader:
                if None in row.values() or row.get(None) is not None:
                    print(f"# resultstore: skipping torn row in "
                          f"{self._csv_path} (config_id="
                          f"{row.get('config_id', '?')})")
                    continue
                self._written_rows.append(row)

    def resume_from_csv(self) -> int:
        """Adopt an existing CSV and rehydrate its rows into ``records``.

        The resume path calls this before the sweep restarts so completed
        config ids are known (dedupe) and the final Pareto front covers
        pre-crash rows; returns the number of records recovered.  Values
        round-trip exactly — Python's float repr is shortest-round-trip, so
        a rehydrated metric compares bit-equal to the original.
        """
        if not self._csv_path:
            return 0
        with self._lock:
            self._adopt_existing_csv()
            for row in self._written_rows:
                try:
                    self.records.append(self._rehydrate(row))
                except (KeyError, TypeError, ValueError) as e:
                    print(f"# resultstore: skipping unreadable row in "
                          f"{self._csv_path}: {e}")
            return len(self.records)

    @staticmethod
    def _rehydrate(row: Dict[str, Any]) -> ResultRecord:
        import ast

        def lit(v):
            try:
                return ast.literal_eval(v)
            except (ValueError, SyntaxError):
                return v            # bare strings (e.g. "bfloat16")

        def num(v):
            try:
                return float(v)
            except ValueError:
                return v        # classification metrics (e.g. bottleneck)

        knobs = {k[len("knob."):]: lit(v) for k, v in row.items()
                 if k and k.startswith("knob.") and v not in (None, "")}
        metrics = {k[len("metric."):]: num(v) for k, v in row.items()
                   if k and k.startswith("metric.") and v not in (None, "")}
        return ResultRecord(
            config_id=int(row["config_id"]), arch=row["arch"],
            shape=row["shape"], knobs=knobs, metrics=metrics,
            status=row["status"], client_id=int(row["client_id"]),
            cached=row["cached"] == "True", wall_s=float(row["wall_s"]))

    def _open_writer(self, mode: str) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
        self._csv_file = open(self._csv_path, mode, newline="")
        self._csv_writer = csv.DictWriter(
            self._csv_file, fieldnames=self._fieldnames(),
            extrasaction="ignore")

    def _append_csv(self, rec: ResultRecord) -> None:
        if self._csv_writer is None:
            os.makedirs(os.path.dirname(self._csv_path) or ".", exist_ok=True)
            self._adopt_existing_csv()
        new_knobs = set(rec.knobs) - self._knob_names
        new_metrics = set(rec.metrics) - self._metric_names
        if self._csv_writer is None or new_knobs or new_metrics:
            # widen the schema and rewrite everything written so far — a
            # frozen header would silently drop the new columns forever
            self._knob_names |= new_knobs
            self._metric_names |= new_metrics
            self._open_writer("w")
            self._csv_writer.writeheader()
            self._csv_writer.writerows(self._written_rows)
        row = self._flatten(rec)
        self._csv_writer.writerow(row)
        self._written_rows.append(row)
        self._csv_file.flush()

    def to_csv(self, path: str) -> None:
        if not self.records:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        knobs = sorted({k for r in self.records for k in r.knobs})
        metrics = sorted({k for r in self.records for k in r.metrics})
        fields = (list(self._BASE_FIELDS) + [f"knob.{k}" for k in knobs]
                  + [f"metric.{k}" for k in metrics])
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            for r in self.records:
                w.writerow(self._flatten(r))

    def to_jsonl(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_wire()) + "\n")

    # -- analysis ------------------------------------------------------------
    def ok_records(self) -> List[ResultRecord]:
        return [r for r in self.records if r.status == "ok"]

    def objective_matrix(self, keys: Sequence[str]) -> np.ndarray:
        return np.asarray([[r.metrics[k] for k in keys] for r in self.ok_records()])

    def pareto_front(self, keys: Sequence[str]) -> List[ResultRecord]:
        recs = self.ok_records()
        if not recs:
            return []
        pts = self.objective_matrix(keys)
        mask = nondominated_mask(pts)
        return [r for r, m in zip(recs, mask) if m]

    def close(self) -> None:
        if self._csv_file:
            self._csv_file.close()
            self._csv_file = self._csv_writer = None
