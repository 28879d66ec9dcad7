"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the port (top-level names compared
whole: the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    found = _imports(path)
    assert "repro_torch" not in found and not found & FORBIDDEN
    assert all(n in {"__future__", "torch", "portbench", "numpy", "math"} for n in found), found


def test_run_refuses_forbidden_modules_by_whole_name():
    code = ("import sys, types; sys.path.insert(0, 'portbench'); import run; "
            "sys.modules['repro_torch_x'] = types.ModuleType('repro_torch_x'); "
            "assert run.forbidden_modules() == []; "
            "sys.modules['repro.core'] = types.ModuleType('repro.core'); "
            "assert run.forbidden_modules() == ['repro'], run.forbidden_modules()")
    subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, check=True, timeout=120)


def test_run_refuses_without_the_port(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dsmoe16b.longdoc",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "the port (src/repro_torch) is not in this checkout" in out.stderr
