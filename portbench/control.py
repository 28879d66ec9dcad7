"""The readings a cell's limit is set from, on the chip, in one process.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 --seconds <s>

For each seed: one whole run of the cell as ``run.py`` makes it (set-up,
the measured window, the check), whose served tokens give the program's
readings (``logit_gap_max``, ``logit_gap_mean``), and on the same prompts
and tokens the control's (``control_gap_max``, ``control_gap_mean``): the
gaps of the tokens that the reference computed in fp8
(``reference.common.Precision(control=True)``) puts first.  One JSON line
per seed; a number's lower reading is the largest program reading over
sound seeds, its upper the smallest control reading.

``--count-drops`` (MoE configurations) also counts, in every MoE layer
call of the runs, the routed assignments over their expert's capacity,
for prefills (one group a prompt) and decode steps (one group of the
active slots), which the reference follows only in the prompt.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import CHECKOUT, environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--count-drops", action="store_true")
    args = ap.parse_args(argv)
    environment()
    import torch

    from portbench.harness import run_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    drops = count_drops() if args.count_drops else None
    t = T_PROCESS
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(bench, args.workload, seed, args.seconds, False,
                       device=torch.device("cuda", 0), t_process=t, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                          "checks": res["checks"]}), flush=True)
        if drops is not None:
            print(json.dumps({"workload": args.workload, "seed": seed, "drops": dict(drops)}),
                  flush=True)
            drops.clear()
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
    return 0


def count_drops() -> dict:
    """Wrap the port's MoE dispatch to count, per kind of call, layer calls,
    tokens, assignments dropped over capacity and tokens that lost one."""
    import collections

    import torch
    from repro_torch.models import moe

    from portbench.reference.decoder import capacity

    counts = collections.Counter()
    inner = moe.dispatch

    def dispatch(h, gate_logits, cfg, want_aux, groups, experts):
        t, e, k = h.shape[0] * h.shape[1], cfg.n_experts, cfg.moe_top_k
        if groups == 1:
            ids = torch.topk(gate_logits.reshape(t, e).float(), k, dim=-1).indices.reshape(-1)
            onehot = torch.nn.functional.one_hot(ids, e)
            rank = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1).view(t, k)
            over = rank >= capacity(t, {"moe_top_k": k, "capacity_factor": cfg.capacity_factor,
                                        "n_experts": e})
            kind = "decode" if h.shape[1] == 1 else "prefill"
            counts[f"{kind}_calls"] += 1
            counts[f"{kind}_tokens"] += t
            counts[f"{kind}_dropped"] += int(over.sum())
            counts[f"{kind}_tokens_with_a_drop"] += int(over.any(dim=-1).sum())
        return inner(h, gate_logits, cfg, want_aux, groups, experts)

    moe.dispatch = dispatch
    return counts


if __name__ == "__main__":
    sys.exit(main())
