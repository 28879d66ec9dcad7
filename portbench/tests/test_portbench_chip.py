"""On the card: each cell's control at the cell's own size, one seed and a
short window: the program's readings keep the cell's limits and the
control (the reference in fp8) breaks one of them.  Run on a machine with
an H100: ``python -m pytest -q -m cuda portbench/tests/test_portbench_chip.py``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_breaks_a_limit_the_program_keeps(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload", cell,
                          "--seeds", "20261018", "--seconds", "10"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    checks = json.loads(out.stdout.strip().splitlines()[-1])["checks"]
    limits = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
    assert all(checks[n]["value"] <= spec["limit"] for n, spec in limits.items()), checks
    assert any(checks[n.replace("logit", "control")]["value"] > spec["limit"]
               for n, spec in limits.items()), checks
