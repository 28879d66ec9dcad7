"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The port (``repro_torch``) is imported from
the checkout's ``src/``; its kernels build into the checkout's
``build/kernels/`` (the first run compiles them), and every other cache
the run could write is pointed into ``build/`` as well.  The last line of
standard output is one JSON object; the numbers ``correct`` was decided
on are the last lines of standard error and the last key of that object.
The run refuses (exit 2, no result) without a CUDA device, with fewer
devices than the cell asks for, or without the port beside it; and
(exit 3, no result) if JAX or the JAX package is loaded once the window
has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment() -> None:
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    for path in (CHECKOUT / "src", CHECKOUT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, JAX's libraries' or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    from portbench.harness import cell_spec

    cell = cell_spec(bench, args.workload)
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from portbench.harness import run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device=torch.device("cuda", 0), t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark runs the port "
              "without JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
