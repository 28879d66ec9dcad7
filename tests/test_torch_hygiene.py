"""The port stands alone: no JAX, no ``repro``, no CPU fallback for the card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as fa

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

_ISOLATION = r"""
import importlib, pkgutil, sys
import numpy as np
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
res = serve.main(["--arch", "llama2-7b", "--reduced", "--batch", "2", "--prompt-len", "8",
                  "--gen", "4", "--device", "cpu", "--attn-impl", "flash"])
assert res.tokens.shape == (2, 4), res.tokens.shape
assert fa.flash_attention.launches == 0
from repro_torch.core import BayesOpt, tpu_pod_space
from repro_torch.core.search import gp_cuda, gp_torch
from repro_torch.kernels import gp_ops
space = tpu_pod_space(n_chips=256)
for mode in ("torch", "cuda"):
    algo = BayesOpt(space, seed=0, n_init=4, pool_size=32, strategy="ehvi", gp_mode=mode,
                    device="cpu")
    for _ in range(8):
        c = algo.ask(1)[0]
        algo.tell(c, space.encode(c)[:2] + 0.5)
assert algo._gp.stats()["cuda_appends"] > 0
assert gp_ops.gp_w.launches == gp_ops.gp_g.launches == gp_ops.gp_ehvi.launches == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("isolated", len(mods))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _ISOLATION], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "isolated" in out.stdout


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.parse_args([]).attn_impl == "flash"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_gp_tiers_default_to_the_card(monkeypatch):
    from repro_torch.core import BayesOpt, PAL, tpu_pod_space
    from repro_torch.core.search.gp_cuda import CudaIncrementalGP
    from repro_torch.core.search.gp_torch import TorchIncrementalGP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = tpu_pod_space(n_chips=256)
    for make in (TorchIncrementalGP, CudaIncrementalGP,
                 lambda: BayesOpt(space, gp_mode="cuda"),
                 lambda: BayesOpt(space, gp_mode="torch", strategy="ehvi"),
                 lambda: PAL(space, gp_mode="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert BayesOpt(space, gp_mode="incremental")._gp.__class__.__name__ == "IncrementalGP"


def test_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, 4, 16)).astype(np.float32))
               for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=8)
    assert fa.flash_attention.launches == before
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v, window=8),
                               atol=0, rtol=0)


def test_other_devices_raise():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, q, q)


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py imports no JAX, and without a card it fails and prints no result."""
    repo = os.path.dirname(SRC)
    with open(os.path.join(repo, "chip_smoke.py")) as f:
        source = f.read()
    assert "import jax" not in source and "from repro." not in source
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(repo, "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300, cwd=repo)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
