"""The port stands alone: no JAX, no ``repro``, no CPU fallback for the card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention as k6
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as k4
from repro_torch.kernels import topk_gating as k5
from repro_torch.models import attention

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
from repro_torch.kernels import ssd_scan as k4, topk_gating as k5
for arch in ("mamba2-780m", "deepseek-moe-16b"):
    res = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--device", "cpu", "--ssd-impl", "cuda"])
    assert res.tokens.shape == (2, 4), res.tokens.shape
res = serve.main(["--arch", "llava-v1.5-7b", "--reduced", "--batch", "2", "--prompt-len", "8",
                  "--gen", "4", "--device", "cpu"])
assert res.tokens.shape == (2, 4), res.tokens.shape
from repro_torch.launch import train
losses = train.main(["--arch", "deepseek-moe-16b", "--reduced", "--batch", "2", "--seq", "8",
                     "--steps", "2", "--log-every", "1", "--device", "cpu"])
assert sorted(losses) == [1, 2], losses
assert k4.ssd_scan.launches == k5.topk_gating.launches == fa.flash_attention.launches == 0
from repro_torch.kernels import decode_attention as k6
assert k6.decode_attention.launches == 0
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
from repro_torch.launch import explore
store = explore.main(["--workload", "llama2-7b", "--reduced", "--samples", "8",
                      "--gp", "incremental", "--algorithm", "bayesopt", "--clients", "2",
                      "--gen-tokens", "8", "--out", sys.argv[1]])
assert len(store.ok_records()) == 8, [r.status for r in store.records]
from repro_torch.launch import dryrun
assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k,decode_32k", "--mesh",
                    "single", "--reduced", "--out", sys.argv[1] + ".jsonl"]) == 0
import json, os
from repro_torch.launch import serve_explore
tmp = os.path.dirname(sys.argv[1])
with open(os.path.join(tmp, "tenants.json"), "w") as f:
    json.dump([{"name": "bo", "algorithm": "bayesopt", "samples": 6, "gp": "cuda"},
               {"name": "rnd", "algorithm": "random", "samples": 4}], f)
served = serve_explore.main(["--workload", "llama2-7b", "--reduced", "--gen-tokens", "8",
                             "--clients", "2", "--fleet-cache", "serve", "--device", "cpu",
                             "--tenants", os.path.join(tmp, "tenants.json"),
                             "--out-dir", tmp, "--checkpoint-root", os.path.join(tmp, "ck")])
assert all(s.state == "done" for s in served.service._sweeps.values())
import importlib.util
examples = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__))),
                        "..", "examples")
for name in ("quickstart", "serve_batched", "train_100m", "multi_board_zmq"):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", os.path.join(examples, f"torch_{name}.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    if name == "quickstart":
        assert len(example.main(["--device", "cpu"]).store.ok_records()) == 40
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("isolated", len(mods))
"""


def test_port_imports_neither_jax_nor_repro(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _ISOLATION, str(tmp_path / "explore.csv")],
                         env=env,
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
    assert serve.parse_args([]).ssd_impl == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_serve_cli_plain_ssd_path_gives_the_same_tokens():
    """``--ssd-impl jnp`` (the plain chunked scan) and the default serve the
    same tokens; on the CPU neither launches K4."""
    from repro_torch.launch import serve

    argv = ["--arch", "mamba2-780m", "--reduced", "--batch", "2", "--prompt-len", "9",
            "--gen", "4", "--device", "cpu"]
    before = k4.ssd_scan.launches
    plain = serve.main(argv + ["--ssd-impl", "jnp"])
    default = serve.main(argv)
    assert k4.ssd_scan.launches == before
    np.testing.assert_array_equal(plain.tokens, default.tokens)


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


def _k4_k5_calls(dev):
    """(wrapper, its call, the plain version's call) for K4, K5 and K6 on small
    inputs.  K6's call is the model's decode attention, which chooses K6 or
    its plain version, and writes the caches in place: each call gets its own
    copy."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 20, 2, 16)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (1, 20, 2)).astype(np.float32)
    b, c = rng.standard_normal((2, 1, 20, 16)).astype(np.float32)
    ssd = [torch.from_numpy(a).to(dev) for a in (x, -dt, b, c, dt)]
    logits = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32)).to(dev)
    cfg = reduced(get_arch("tinyllama-1.1b"))
    attn = attention.Attention(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0)).to(dev)
    hx = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)).to(dev)
    caches = torch.from_numpy(rng.standard_normal((2, 2, 24, cfg.n_kv_heads, cfg.d_head))
                              .astype(np.float32)).to(dev)
    pos = torch.tensor([3, 23], dtype=torch.int32, device=dev)

    def decode_plain():
        o = attention.decode_attention_plain(*attention._project(attn, hx, cfg), *caches.clone(),
                                             pos, cfg.rope_theta, window=8)
        return attention._out(attn, o)
    return {
        "ssd_scan": (k4.ssd_scan, lambda: k4.ssd_scan(*ssd, chunk=256),
                     lambda: k4.ssd_scan_plain(*ssd, chunk=k4.clamp_chunk(256, 20))),
        "topk_gating": (k5.topk_gating, lambda: k5.topk_gating(logits, 3),
                        lambda: k5.topk_gating_plain(logits, 3)),
        "decode_attention": (
            k6.decode_attention,
            lambda: attention.decode_attention(attn, hx, dict(zip("kv", caches.clone())), pos,
                                               cfg, window=8)[0],
            decode_plain),
    }


@pytest.mark.parametrize("kernel", ["ssd_scan", "topk_gating", "decode_attention"])
def test_k4_k5_cpu_tensors_take_plain_versions(kernel):
    wrapper, call, plain = _k4_k5_calls("cpu")[kernel]
    before = wrapper.launches
    got = call()
    assert wrapper.launches == before
    for g, w in zip(got, plain()):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("kernel", ["ssd_scan", "topk_gating", "decode_attention"])
def test_k4_k5_other_devices_raise(kernel):
    """A meta tensor: K4 raises; K5 returns its outputs' shapes and launches
    nothing (the explore loop's MoE builds on meta), and still raises for a
    malformed input there; the model's decode attention takes K6's plain
    version there (the explore loop's count), and K6 itself raises."""
    wrapper, call, plain = _k4_k5_calls("meta")[kernel]
    if kernel == "ssd_scan":
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()
        return
    before = wrapper.launches
    got = call()
    assert wrapper.launches == before
    for g, w in zip(got, _k4_k5_calls("cpu")[kernel][2]()):
        assert g.device.type == "meta" and g.shape == w.shape and g.dtype == w.dtype
    if kernel == "topk_gating":
        with pytest.raises(ValueError, match="float32 logits"):
            k5.topk_gating(torch.empty((4, 8), device="meta", dtype=torch.bfloat16), 2)
    else:
        q, kv, cache = (torch.empty(s, device="meta")
                        for s in ((2, 1, 4, 16), (2, 1, 2, 16), (2, 8, 2, 16)))
        with pytest.raises(ValueError, match="runs on cuda"):
            k6.decode_attention(q, kv, kv, cache, cache, 3, 1e4)


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
