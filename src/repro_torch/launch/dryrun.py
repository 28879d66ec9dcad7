"""Dry run: count every (arch × shape × mesh) cell (port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \
        --mesh single,multi --out results/dryrun_torch.jsonl

The reference lowers and compiles each cell on 512 fake XLA devices and
extrapolates per-layer costs from two shallow unrolled builds, because
XLA's cost analysis counts a scanned body once (``dryrun.py:14-20``).  The
port's cell is ``launch.build.build_cell``, which counts the whole model
(every layer) on the ``meta`` device: nothing is compiled or allocated and
no card is needed, and the costs need no extrapolation.  Meshes:
``single`` is (data, model) = (16, 16), ``multi`` (pod, data, model) =
(2, 16, 16), counted with its pod axis folded into data (the rules shard
over pod × data together), and ``DPxTP`` any other factorisation.

Per cell the record holds the reference's fields (``memory``, ``meta``,
``cost``, ``roofline`` on the reference's modeled board) and a fit check
against one H100's 80 GB of HBM (NVIDIA's data sheet): ``fits_80g_hbm``
for the per-device peak at this mesh, and ``one_card_bytes`` /
``fits_one_card`` for the whole cell on one card
(``meta["one_device_bytes"]``): jamba-v0.1-52b's bf16 weights alone, about
104 GB, do not fit one card.  Results stream to a JSONL, resumable: a cell
already in the file (arch, shape, mesh, variant) is skipped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

CARD_HBM_BYTES = 80e9          # one H100 SXM (NVIDIA's data sheet: 80 GB)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="all", help="arch id, csv, or 'all'")
    p.add_argument("--shape", default="all", help="shape name, csv, or 'all'")
    p.add_argument("--mesh", default="single,multi")
    p.add_argument("--out", default="results/dryrun_torch.jsonl")
    p.add_argument("--force", action="store_true")
    p.add_argument("--flags", default="", help="k=v csv of BuildFlags overrides")
    p.add_argument("--variant", default="baseline", help="label for §Perf runs")
    p.add_argument("--skip-costs", action="store_true",
                   help="the memory record only (no cost and roofline blocks)")
    p.add_argument("--reduced", action="store_true",
                   help="reduced same-family configs (repro_torch.configs.reduced), "
                        "keeping each arch's SSD chunk: the shapes are long")
    return p.parse_args(argv)


def build_flags_from(s: str):
    from repro_torch.models.model import BuildFlags

    kw = {}
    if s:
        for kv in s.split(","):
            k, v = kv.split("=")
            field = {f.name: f for f in dataclasses.fields(BuildFlags)}[k]
            if field.type in ("bool", bool):
                kw[k] = v.lower() in ("1", "true", "yes")
            elif field.type in ("int", int):
                kw[k] = int(v)
            else:
                kw[k] = v
    return BuildFlags(**kw)


def mesh_factors(name: str):
    """(tag, dp, tp) of a mesh name: ``single``, ``multi`` or ``DPxTP``."""
    if name == "single":
        return "16x16", 16, 16
    if name == "multi":
        return "2x16x16", 32, 16
    dp, tp = (int(x) for x in name.split("x"))
    return name, dp, tp


def measure_cell(arch, shape, dp, tp, tag, flags, skip_costs=False):
    """The dry-run record of one cell, and its Artifact."""
    from repro_torch.launch.build import build_cell

    t0 = time.time()
    cell = build_cell(arch, shape, dp, tp, flags)
    art = cell.artifact
    peak = art.peak_memory_per_device
    one = cell.meta["one_device_bytes"]
    rec = {
        "arch": arch.name, "shape": shape.name, "mesh": tag, "n_devices": dp * tp,
        "kind": cell.kind,
        "flags": dataclasses.asdict(flags),
        "build_s": round(time.time() - t0, 2),
        "memory": {
            "arg_bytes": art.arg_bytes,
            "temp_bytes": art.temp_bytes,
            "output_bytes": art.output_bytes,
            "peak_per_device": peak,
            "fits_80g_hbm": peak <= CARD_HBM_BYTES,
            "one_card_bytes": one,
            "fits_one_card": one <= CARD_HBM_BYTES,
        },
        "meta": cell.meta,
    }
    if not skip_costs:
        rec["cost"] = {
            "flops_per_device": art.flops_per_device,
            "bytes_per_device": art.bytes_per_device,
            "wire_bytes_per_device": art.wire_bytes_per_device,
            "collectives": art.collectives,
            "method": "whole model counted on meta",
        }
    return rec, art


def roofline_record(rec, art, arch, shape, flags, dp, tp):
    """The reference's roofline block, on its modeled board (``roofline.hw``)."""
    from repro_torch.launch.build import pick_optimizer
    from repro_torch.models.model import count_params_analytic
    from repro_torch.roofline.hw import HwModel
    from repro_torch.roofline.traffic import analytic_hbm_bytes_per_device

    hw = HwModel(n_chips=art.n_devices)
    _, opt_name = pick_optimizer(arch) if shape.kind == "train" else (None, "none")
    art.hbm_est_per_device = analytic_hbm_bytes_per_device(
        arch, shape, flags, art.n_devices, dp, tp, optimizer=opt_name)
    terms = hw.roofline_terms(art.global_flops,
                              art.effective_bytes_per_device * art.n_devices,
                              art.wire_bytes_per_device * art.n_devices)
    terms_raw = hw.roofline_terms(art.global_flops, art.bytes_per_device * art.n_devices,
                                  art.wire_bytes_per_device * art.n_devices)
    n_active = count_params_analytic(arch, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    rec["roofline"] = {
        **terms,
        "memory_s_hlo_raw": terms_raw["memory_s"],
        "hbm_est_per_device": art.hbm_est_per_device,
        "model_flops": model_flops,
        "hlo_flops_global": art.global_flops,
        "useful_ratio": model_flops / art.global_flops if art.global_flops else 0.0,
        "roofline_fraction": (terms["compute_s"] / terms["step_time_s"]
                              if terms["step_time_s"] else 0.0),
    }
    return rec


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_arch, reduced, shape_applicable

    archs = ASSIGNED_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [mesh_factors(m) for m in args.mesh.split(",")]
    flags = build_flags_from(args.flags)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"], r.get("variant")))
                except (ValueError, KeyError):
                    pass

    n_ok = n_skip = n_fail = 0
    with open(args.out, "a") as out:
        for aname in archs:
            arch = get_arch(aname)
            if args.reduced:
                arch = reduced(arch, ssm_chunk=arch.ssm_chunk)
            for sname in shapes:
                shape = SHAPES[sname]
                runs, why = shape_applicable(arch, shape)
                for tag, dp, tp in meshes:
                    key = (arch.name, shape.name, tag, args.variant)
                    if key in done:
                        n_skip += 1
                        continue
                    if not runs:
                        rec = {"arch": arch.name, "shape": shape.name, "mesh": tag,
                               "variant": args.variant, "status": "skipped", "reason": why}
                        out.write(json.dumps(rec) + "\n")
                        out.flush()
                        print(f"[skip] {arch.name} × {shape.name} × {tag}: {why}")
                        continue
                    t0 = time.time()
                    try:
                        rec, art = measure_cell(arch, shape, dp, tp, tag, flags,
                                                skip_costs=args.skip_costs)
                        if not args.skip_costs:
                            rec = roofline_record(rec, art, arch, shape, flags, dp, tp)
                        rec["status"] = "ok"
                        rec["variant"] = args.variant
                        n_ok += 1
                        mem = rec["memory"]
                        extra = ""
                        if "roofline" in rec:
                            r = rec["roofline"]
                            extra = (f" dom={r['dominant']}"
                                     f" step={r['step_time_s']*1e3:.1f}ms"
                                     f" rf={r['roofline_fraction']:.2f}")
                        print(f"[ok]   {arch.name} × {shape.name} × {tag} "
                              f"({time.time()-t0:.0f}s, "
                              f"peak={mem['peak_per_device']/2**30:.1f}GiB/device "
                              f"{'fits' if mem['fits_80g_hbm'] else 'does NOT fit'} 80 GB; "
                              f"one card {mem['one_card_bytes']/1e9:.1f} GB "
                              f"{'fits' if mem['fits_one_card'] else 'does NOT fit'})" + extra)
                    except Exception:
                        rec = {"arch": arch.name, "shape": shape.name, "mesh": tag,
                               "variant": args.variant, "status": "failed",
                               "error": traceback.format_exc(limit=8)}
                        n_fail += 1
                        print(f"[FAIL] {arch.name} × {shape.name} × {tag} "
                              f"({time.time()-t0:.0f}s)")
                        print(rec["error"].splitlines()[-1])
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
    print(f"\ndone: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
