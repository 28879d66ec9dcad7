"""Multi-board exploration over ZMQ on the port: the paper's deployment
shape.  The counterpart of ``examples/multi_board_zmq.py``.

    PYTHONPATH=src python examples/torch_multi_board_zmq.py [--device cpu]

Spawns two client *processes* (stand-ins for two boards), each binding a
ZMQ PULL socket for configs and PUSHing results back to the host, the
socket roles of paper §III.  The host runs NSGA-II (population 12) over 48
configs of the 64-chip ``tpu_pod_space`` through the pipelined dispatch
scheduler: chunks of configs travel as single columnar frames in the
binary codec, every board's queue is kept two chunks deep, and chunk sizes
adapt to each board's per-config wall time under a 250 ms budget.  Every
board builds the same md5 stand-in ``Artifact`` from a config's knobs (a
real board would build the model there) and reports its artifact-cache
counters (``cache_info``) on exit.  The ports are arguments (the
reference's by default).  Needs pyzmq.  The stand-in touches no device:
``--device`` only checks that the card is there (the port's entry points
run on the card unless the caller names the CPU).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
sys.path.insert(0, SRC)

CLIENT_CODE_TEMPLATE = """
import sys
sys.path.insert(0, SRC_PATH)
from repro_torch.core import JClient, JConfig, tpu_pod_space, transport
from repro_torch.roofline.analysis import Artifact

cid, cfg_port, res_port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
space = tpu_pod_space(n_chips=64)
jc = JConfig(space, n_chips=64)

def build(tc):
    # stand-in workload (a real board would build the model here)
    import hashlib
    h = int(hashlib.md5(str(sorted(tc.knobs.items())).encode()).hexdigest(), 16)
    return Artifact(flops_per_device=4e12 + (h % 7) * 1e11,
                    bytes_per_device=2e10, wire_bytes_per_device=2e8,
                    collectives={}, arg_bytes=10**9, temp_bytes=10**8,
                    output_bytes=10**6, n_devices=64), {}

# the client stays codec-agnostic: it sniffs the host's frames and answers
# in the same codec (binary here, since the host speaks binary)
t = transport.ZmqClientTransport(f"tcp://127.0.0.1:{cfg_port}",
                                 f"tcp://127.0.0.1:{res_port}")
client = JClient(jc, build, transport=t, client_id=cid)
served = client.serve(poll_s=0.2, idle_limit_s=30)
info = client.cache_info()
print(f"[board {cid}] served {served} configs, compiled {client.n_compiled}; "
      f"cache_info: hits={info['hits']} misses={info['misses']} "
      f"evictions={info['evictions']} currsize={info['currsize']}", flush=True)
t.close()
t.close()   # close is idempotent: double-close in teardown paths is safe
"""
CLIENT_CODE = ("SRC_PATH = %r\n" % os.path.abspath(SRC)) + CLIENT_CODE_TEMPLATE
N_CONFIGS = 48


def main(argv=None):
    """Run the sweep; returns the JHost (its ``store`` holds the records)."""
    from repro_torch.core import JHost, NSGA2, ResultStore, tpu_pod_space, transport
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--cfg-ports", default="15701,15702",
                    help="the two boards' config ports")
    ap.add_argument("--res-port", type=int, default=15700, help="the host's result port")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    cfg_ports = [int(p) for p in args.cfg_ports.split(",")]
    res_port = args.res_port

    procs = [subprocess.Popen([sys.executable, "-c", CLIENT_CODE,
                               str(i), str(cfg_ports[i]), str(res_port)])
             for i in range(2)]
    host_t = None
    try:
        time.sleep(1.0)  # let boards bind
        host_t = transport.ZmqHostTransport(
            f"tcp://*:{res_port}",
            {i: f"tcp://127.0.0.1:{cfg_ports[i]}" for i in range(2)},
            codec="binary")
        space = tpu_pod_space(n_chips=64)
        host = JHost(host_t, ResultStore(), timeout_s=20.0)
        t0 = time.time()
        host.explore(NSGA2(space, seed=0, pop_size=12), "toy", "train_4k", N_CONFIGS,
                     progress=True, batch_size=6, dispatch="pipelined",
                     chunk_budget_ms=250.0)
        wall = time.time() - t0
        host.stop_clients()

        front = host.store.pareto_front(["time_s", "power_w"])
        by_client = {}
        for r in host.store.ok_records():
            by_client[r.client_id] = by_client.get(r.client_id, 0) + 1
        stats = host.scheduler.stats()
        print(f"explored {N_CONFIGS} configs in {wall:.2f}s across boards {by_client}; "
              f"pareto front = {len(front)} points; "
              f"{stats['chunks_dispatched']:.0f} chunks "
              f"(mean size {stats['mean_chunk']:.1f}, pipelined+binary)")
        if "wire_per_client" in stats:        # per-board codec/bytes-on-wire
            for cid, w in sorted(stats["wire_per_client"].items()):
                print(f"  board {cid}: {w['out_kb']:.1f} KB out in "
                      f"{w['out_frames']} frames, {w['in_kb']:.1f} KB back in "
                      f"{w['in_frames']} frames ({stats.get('codec', '?')})")
        for p in procs:
            p.wait(timeout=40)
        return host
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if host_t is not None:
            host_t.close()


if __name__ == "__main__":
    main()
