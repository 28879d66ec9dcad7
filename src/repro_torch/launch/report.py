"""Generate the EXPERIMENTS.md §Dry-run / §Roofline tables from
results/dryrun.jsonl, plus end-of-run reporting helpers shared by
``launch.explore`` and the benchmark harness (``cache_effectiveness``).
A copy of ``repro/launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report [--in results/dryrun.jsonl]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict


def cache_effectiveness(cache_infos):
    """Fold per-client ``JClient.cache_info()`` dicts into one human summary
    line and a flat totals dict (the ``results/bench.json`` fleet-row
    payload).  ``hits``/``misses`` are the in-memory LRU, ``disk_*`` the
    persistent tier.  The reference's fleet-store and per-tenant parts
    (``fleet_stats``) come with ROADMAP slice 6.
    """
    totals = defaultdict(int)
    for ci in cache_infos or ():
        for k, v in (ci or {}).items():
            if k == "maxsize":
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                totals[k] += v
    out = dict(totals)
    out["n_clients"] = len(cache_infos or ())
    parts = [f"lru {out.get('hits', 0)}/{out.get('hits', 0) + out.get('misses', 0)} hits"]
    if "disk_hits" in out:
        parts.append(f"disk {out['disk_hits']}/"
                     f"{out['disk_hits'] + out.get('disk_misses', 0)} hits")
    return "cache: " + ", ".join(parts), out


def load(path, variant="baseline"):
    cells = {}
    for line in open(path):
        try:
            r = json.loads(line)
        except Exception:
            continue
        if r.get("variant", "baseline") != variant:
            continue
        cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt_t(s):
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.1f}ms"
    return f"{s*1e6:.0f}µs"


def fmt_b(b):
    if b >= 2 ** 30:
        return f"{b/2**30:.1f}GiB"
    return f"{b/2**20:.0f}MiB"


DOM = {"compute_s": "compute", "memory_s": "memory", "collective_s": "collective"}


def roofline_table(cells, mesh="16x16"):
    rows = ["| arch | shape | compute | memory (est) | collective | bottleneck "
            "| step | RF | 6ND/HLO | peak mem/dev | fits 16G |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        if r.get("status") == "skipped":
            rows.append(f"| {arch} | {shape} | — | — | — | skipped | — | — | — "
                        f"| — | ({r['reason'].split(':')[0]}) |")
            continue
        if r.get("status") != "ok" or "roofline" not in r:
            rows.append(f"| {arch} | {shape} | FAILED | | | | | | | | |")
            continue
        ro = r["roofline"]
        mem = r["memory"]
        rows.append(
            f"| {arch} | {shape} | {fmt_t(ro['compute_s'])} "
            f"| {fmt_t(ro['memory_s'])} | {fmt_t(ro['collective_s'])} "
            f"| {DOM.get(ro['dominant'], ro['dominant'])} "
            f"| {fmt_t(ro['step_time_s'])} | {ro['roofline_fraction']:.2f} "
            f"| {ro['useful_ratio']:.2f} | {fmt_b(mem['peak_per_device'])} "
            f"| {'yes' if mem['fits_16g_hbm'] else 'NO'} |")
    return "\n".join(rows)


def dryrun_table(cells):
    """Compile-proof summary: one row per (arch, shape), both meshes."""
    byas = defaultdict(dict)
    for (arch, shape, m), r in cells.items():
        byas[(arch, shape)][m] = r
    rows = ["| arch | shape | 16×16 | 2×16×16 | compile s (single/multi) "
            "| bytes/dev | top collectives (single) |",
            "|---|---|---|---|---|---|---|"]
    for (arch, shape), by in sorted(byas.items()):
        marks, comps = [], []
        for m in ("16x16", "2x16x16"):
            r = by.get(m)
            if r is None:
                marks.append("—")
                comps.append("—")
            elif r.get("status") == "ok":
                marks.append("✓")
                comps.append(f"{r.get('compile_s', 0):.0f}")
            elif r.get("status") == "skipped":
                marks.append("skip")
                comps.append("—")
            else:
                marks.append("FAIL")
                comps.append("—")
        r = by.get("16x16", {})
        mem = r.get("memory", {})
        coll = (r.get("cost", {}) or {}).get("collectives", {})
        top = ", ".join(f"{k}:{fmt_b(v)}" for k, v in
                        sorted(coll.items(), key=lambda kv: -kv[1])[:2])
        rows.append(f"| {arch} | {shape} | {marks[0]} | {marks[1]} "
                    f"| {comps[0]}/{comps[1]} "
                    f"| {fmt_b(mem.get('peak_per_device', 0))} | {top} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="results/dryrun.jsonl")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--section", default="all", choices=["all", "dryrun", "roofline"])
    args = ap.parse_args()
    cells = load(args.inp, args.variant)
    if args.section in ("all", "dryrun"):
        print("### Dry-run matrix\n")
        print(dryrun_table(cells))
        print()
    if args.section in ("all", "roofline"):
        print("### Roofline (single pod, 16×16 = 256 chips)\n")
        print(roofline_table(cells))


if __name__ == "__main__":
    main()
