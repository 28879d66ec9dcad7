"""Quickstart on the port: explore a design space over a real workload
in-process.  The counterpart of ``examples/quickstart.py``.

    python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

This is the 60-second version of the paper's Algorithm 1: a JHost drives two
JClients (threads here; separate hosts on a real fleet) that build a small
llama-family model once per software-knob variant and evaluate the hardware
ladders analytically, then prints the time/power Pareto frontier.  A build
(``launch.build.build_generation``) counts the model on the ``meta``
device, so the sweep itself allocates nothing on the card; ``--device``
only checks that the card is there (the port's entry points run on the card
unless the caller names the CPU).
"""
from __future__ import annotations

import argparse
import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.core import (JClient, JConfig, JHost, RandomSearch, ResultStore,
                              transport)
from repro_torch.core.space import KIND_HW, KIND_SW, DesignSpace, Knob
from repro_torch.device import resolve_device
from repro_torch.launch import build as launch_build
from repro_torch.roofline.hw import CLOCK_LADDER, HBM_LADDER, ICI_LADDER
from repro_torch.roofline.traffic import analytic_hbm_bytes_per_device

N_CONFIGS = 40


def make_space() -> DesignSpace:
    """Table I of the TPU adaptation, as the reference's quickstart has it."""
    return DesignSpace([
        Knob("clock_scale", CLOCK_LADDER, KIND_HW),   # GPU-freq analogue
        Knob("hbm_scale", HBM_LADDER, KIND_HW),       # EMC-freq analogue
        Knob("ici_scale", ICI_LADDER, KIND_HW),
        Knob("attn_block_q", (16, 32), KIND_SW),      # kernel tiling (rebuilds)
    ])


def make_build(jc: JConfig, arch):
    """The workload: greedy generation with ``arch`` (a prompt of 16, a
    48-slot cache, 32 decode tokens), built on one device."""
    def build(tc):
        flags = jc.build_flags(tc.knobs)
        pre_cell, dec_cell = launch_build.build_generation(arch, 1, 1, flags, batch=1,
                                                           prompt_len=16, max_len=48)
        pre, dec = pre_cell.artifact, dec_cell.artifact
        pre.hbm_est_per_device = analytic_hbm_bytes_per_device(
            arch, ShapeConfig("p", "prefill", 16, 1), flags, 1, 1, 1)
        dec.hbm_est_per_device = analytic_hbm_bytes_per_device(
            arch, ShapeConfig("d", "decode", 48, 1), flags, 1, 1, 1)
        return pre, {"decode_artifact": dec, "n_decode_tokens": 32}
    return build


def main(argv=None):
    """Run the sweep and print the frontier; returns the JHost (its
    ``store`` holds the records)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    # 1. the design space
    space = make_space()
    jc = JConfig(space, n_chips=1)
    # 2. the workload: anything; here greedy generation with a reduced llama2
    arch = reduced(get_arch("llama2-7b"))
    build = make_build(jc, arch)

    # 3. boards (threads here, ZMQ hosts on a fleet) + host + search algorithm
    pair = transport.LoopbackPair(2)
    for i in range(2):
        c = JClient(jc, build, transport=pair.client(i), client_id=i)
        threading.Thread(target=c.serve, kwargs=dict(poll_s=0.02, idle_limit_s=None),
                         daemon=True).start()
    host = JHost(pair.host(), ResultStore(), timeout_s=300)
    host.explore(RandomSearch(space, seed=0), arch.name, "generate", N_CONFIGS)

    # 4. results
    front = host.store.pareto_front(["time_s", "power_w"])
    print(f"\nexplored {N_CONFIGS} configs; pareto frontier ({len(front)} points):")
    for r in sorted(front, key=lambda r: r.metrics["time_s"]):
        print(f"  time {r.metrics['time_s']*1e3:8.3f} ms   power {r.metrics['power_w']:5.1f} W"
              f"   clock={r.knobs['clock_scale']:<5} hbm={r.knobs['hbm_scale']:.3f}"
              f" ici={r.knobs['ici_scale']:.2f}")
    host.stop_clients()
    return host


if __name__ == "__main__":
    main()
