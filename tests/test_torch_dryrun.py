"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, no card.

A reduced grid (tinyllama-1.1b and mamba2-780m, reduced, × all four shapes
× the single-pod (16, 16) mesh, counted on ``meta``): one JSONL row per
cell with the reference's fields, long_500k skipped for the
full-attention arch as the reference skips it, the roofline on the
reference's modeled board; a second run with the same output rebuilds
nothing; the fit check against one H100's 80 GB: jamba-v0.1-52b at full
width does not fit one card, a reduced model does.
"""
import json

import pytest

from repro_torch.configs import SHAPES
from repro_torch.launch import build, dryrun

ARGV = ["--arch", "tinyllama-1.1b,mamba2-780m", "--shape", "all", "--mesh", "single",
        "--reduced"]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    assert dryrun.main(ARGV + ["--out", str(out)]) == 0
    return out


def test_grid_rows(grid):
    rows = _rows(grid)
    assert len(rows) == 2 * len(SHAPES)
    by = {(r["arch"], r["shape"]): r for r in rows}
    skipped = by[("tinyllama-1.1b-reduced", "long_500k")]
    assert skipped["status"] == "skipped" and "long_500k" in skipped["reason"]
    ok = [r for r in rows if r["status"] == "ok"]
    assert len(ok) == 2 * len(SHAPES) - 1
    for r in ok:
        assert r["mesh"] == "16x16" and r["n_devices"] == 256 and r["variant"] == "baseline"
        assert r["kind"] == SHAPES[r["shape"]].kind
        assert r["cost"]["flops_per_device"] > 0 and r["cost"]["method"]
        mem = r["memory"]
        assert mem["peak_per_device"] == mem["arg_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
        assert mem["fits_80g_hbm"]
        assert r["roofline"]["step_time_s"] > 0 and r["roofline"]["model_flops"] > 0
    train = by[("tinyllama-1.1b-reduced", "train_4k")]
    assert train["meta"]["optimizer"] == "adamw"


def test_resume_rebuilds_nothing(grid, monkeypatch, capsys):
    def refuse(*a, **kw):
        raise AssertionError("a finished cell was built again")
    monkeypatch.setattr(build, "build_cell", refuse)
    n = len(_rows(grid))
    assert dryrun.main(ARGV + ["--out", str(grid)]) == 0
    assert len(_rows(grid)) == n
    assert f"skip={n}" in capsys.readouterr().out


def test_fit_check_on_one_card(tmp_path, capsys):
    out = tmp_path / "fit.jsonl"
    assert dryrun.main(["--arch", "jamba-v0.1-52b", "--shape", "decode_32k", "--mesh",
                        "1x1,16x16", "--out", str(out), "--skip-costs"]) == 0
    rows = {r["mesh"]: r for r in _rows(out)}
    one, pod = rows["1x1"]["memory"], rows["16x16"]["memory"]
    assert one["one_card_bytes"] > 104e9 and not one["fits_one_card"]
    assert not one["fits_80g_hbm"] and one["peak_per_device"] == one["one_card_bytes"]
    assert pod["fits_80g_hbm"] and not pod["fits_one_card"]
    assert "cost" not in rows["1x1"]
    assert "does NOT fit)" in capsys.readouterr().out
