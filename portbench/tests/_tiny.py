"""Tiny sizes of the benchmark's configurations and mixes, for CPU tests."""
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
TINY = {
    "dsmoe16b": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                     n_experts=8, moe_top_k=2, moe_d_ff=32, n_shared_experts=1, vocab_size=256,
                     dtype="float32"),
    "mamba2": dict(n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                   vocab_size=256, dtype="float32"),
}
TRAFFIC = {"slots": 4, "max_len": 128, "check_tokens": 10**6,
           "prompt": {"law": "lognormal", "median": 16, "sigma": 1.0, "min": 4, "max": 48},
           "output": {"law": "lognormal", "median": 5, "sigma": 0.7, "min": 2, "max": 10}}


def bench() -> dict:
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(TINY[name])
    return cfg


def overrides(cell: str, limits=None) -> dict:
    out = {"config": TINY[cell.split(".")[0]], "traffic": TRAFFIC}
    if limits is not None:
        out["limits"] = limits
    return out
