"""The port's four examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``), on the CPU (``--device cpu``):

* serve_batched: each arch's greedy tokens equal the reference example's
  loop (its ``Engine`` on ``model.init(jax.random.key(0))`` weights,
  carried across by ``params_from_jax``), in fp32; the port's ``main``
  prints the reference's line per arch;
* train_100m ``--tiny`` (at batch 4 × 64): the losses of 4 steps against
  the reference example's loop at ``tests/test_torch_train.py``'s loss
  tolerance, from the reference's weights; a resume from the step-50
  checkpoint of a 52-step run gives steps 51 and 52 bit for bit, with the
  reference's message;
* quickstart: run with one stub build (a fixed function of the knobs) in
  both packages, the records keyed by config id are equal (knobs,
  metrics, status); the port's own meta build gives finite metrics for a
  few configs;
* multi_board_zmq (pyzmq): two client processes on free ports serve the
  48 configs, every record ok, and each config's metrics equal the
  reference's ``JClient.evaluate`` of the reference example's md5
  stand-in build for the same knobs.
"""
import dataclasses
import hashlib
import importlib.util
import math
import os
import runpy
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(atol=0, rtol=1e-5)          # tests/test_torch_train.py's


def _example(name):
    path = os.path.join(REPO, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------


def _ref_serve(name):
    """The reference example's loop for one arch -> (its tokens, its weights)."""
    from repro.configs import get_arch, reduced
    from repro.models import BuildFlags, Model
    from repro.serve import Engine

    arch = reduced(get_arch(name))
    model = Model(arch, BuildFlags(dtype="float32", remat="none", sp=False))
    params = model.init(jax.random.key(0))
    eng = Engine(model, params, max_len=64, donate=False)
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, arch.vocab_size, (4, 12)), jnp.int32)}
    return np.asarray(eng.generate(batch, 24).tokens), jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-780m", "deepseek-moe-16b"])
def test_serve_batched_tokens_equal_reference(arch):
    from repro_torch.configs import get_arch, reduced

    ex = _example("serve_batched")
    want, params = _ref_serve(arch)
    got, _ = ex.serve(arch, torch.device("cpu"), params_from_jax(params, reduced(get_arch(arch))))
    assert got.shape == (4, 24) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_serve_batched_main_prints_the_reference_lines(capsys):
    out = _example("serve_batched").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert sorted(out) == sorted(["tinyllama-1.1b", "mamba2-780m", "deepseek-moe-16b"])
    assert len(lines) == 3
    for line, (name, (tokens, _)) in zip(lines, out.items()):
        assert line.startswith(f"{name:<22s} batch=4 prompt=12 gen=24 ")
        assert line.endswith(f"first: {tokens[0][:8].tolist()}") and "tok/s" in line


# ---------------------------------------------------------------------------
# train_100m --tiny
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--tiny", "--batch", "4", "--seq", "64", "--device", "cpu"]


def _ref_train(steps, batch=4, seq=64):
    """The reference example's loop (``--tiny``) -> (losses, initial weights)."""
    from repro.configs import get_arch
    from repro.data import DataConfig, SyntheticLM, device_put_batch
    from repro.models import BuildFlags, Model
    from repro.train import (TrainStepConfig, adamw, cosine_schedule, init_train_state,
                             make_train_step)

    arch = dataclasses.replace(get_arch("tinyllama-1.1b"), name="llama-6m", n_layers=4,
                               d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=512,
                               vocab_size=4096)
    model = Model(arch, BuildFlags(dtype="float32", remat="selective", sp=False))
    opt = adamw(cosine_schedule(3e-4, steps // 10, steps))
    tsc = TrainStepConfig(microbatch=1)
    state = init_train_state(model, opt, jax.random.key(0), tsc)
    params = jax.tree.map(np.asarray, state["params"])
    step_fn = jax.jit(make_train_step(model, opt, tsc))
    data = SyntheticLM(arch, DataConfig(batch, seq, seed=0))
    losses = []
    for step in range(steps):
        state, m = step_fn(state, device_put_batch(data.batch(step)))
        losses.append(float(m["loss"]))
    return losses, params


def test_train_100m_tiny_matches_reference(tmp_path):
    """4 steps from the reference's weights: its losses at LOSS_TOL, and
    the final checkpoint written."""
    ex = _example("train_100m")
    want, params = _ref_train(4)
    ck = str(tmp_path / "ck")
    got = ex.main(TRAIN_ARGS + ["--steps", "4", "--ckpt", ck],
                  weights=params_from_jax(params, ex.arch_for(True)))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got[-1] < got[0]
    assert os.listdir(ck) == ["step_00000004"]


def test_train_100m_tiny_resumes_bitwise(tmp_path, capsys):
    """52 steps write the step-50 and step-52 checkpoints; a rerun from
    the step-50 one alone prints the reference's message and gives steps
    51 and 52 bit for bit."""
    import shutil

    ex = _example("train_100m")
    ck, resume = str(tmp_path / "ck"), str(tmp_path / "resume")
    got = ex.main(TRAIN_ARGS + ["--steps", "52", "--ckpt", ck])
    assert sorted(os.listdir(ck)) == ["step_00000050", "step_00000052"]
    assert got[-1] < got[0]
    shutil.copytree(os.path.join(ck, "step_00000050"), os.path.join(resume, "step_00000050"))
    capsys.readouterr()
    again = ex.main(TRAIN_ARGS + ["--steps", "52", "--ckpt", resume])
    assert "resumed from step 50" in capsys.readouterr().out
    assert again == got[50:]                       # bitwise


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def _stub_cells(artifact_cls, flags, field):
    """Prefill and decode cells of a fixed function of the flags' tile knob,
    their artifact under ``field``."""
    q = flags.attn_block_q

    def cell(f):
        art = artifact_cls(flops_per_device=1e9 * f * (1 + q / 64), bytes_per_device=3e7 * f,
                           wire_bytes_per_device=0.0, collectives={},
                           arg_bytes=int(2e7 * f), temp_bytes=int(q * 1000),
                           output_bytes=int(4e4 * f), n_devices=1)
        return type("Cell", (), {field: art})()
    return cell(1.0), cell(0.05)


def _records(store):
    return {r.config_id: (r.knobs, r.metrics, r.status) for r in store.records}


def test_quickstart_records_equal_reference_on_a_stub_build(monkeypatch, capsys):
    from repro.launch import build as ref_build
    from repro.roofline import analysis as ref_analysis
    from repro_torch.launch import build as port_build
    from repro_torch.roofline import analysis as port_analysis

    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    monkeypatch.setattr(ref_build, "build_generation", lambda arch, mesh, flags, **kw:
                        _stub_cells(ref_analysis.Artifact, flags, "compiled"))
    monkeypatch.setattr(ref_analysis, "summarize", lambda compiled, n: compiled)
    ref = runpy.run_path(os.path.join(REPO, "examples", "quickstart.py"))["host"]
    monkeypatch.setattr(port_build, "build_generation", lambda arch, dp, tp, flags, **kw:
                        _stub_cells(port_analysis.Artifact, flags, "artifact"))
    host = _example("quickstart").main(["--device", "cpu"])
    want, got = _records(ref.store), _records(host.store)
    assert sorted(got) == list(range(40)) and got == want
    assert all(status == "ok" for _, _, status in got.values())
    assert "explored 40 configs; pareto frontier" in capsys.readouterr().out


def test_quickstart_meta_build_runs():
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import JClient, JConfig, RandomSearch, TestConfig

    ex = _example("quickstart")
    space = ex.make_space()
    jc = JConfig(space, n_chips=1)
    client = JClient(jc, ex.make_build(jc, reduced(get_arch("llama2-7b"))), client_id=0)
    for i, knobs in enumerate(RandomSearch(space, seed=0).ask(3)):
        rec = client.evaluate(TestConfig(i, "llama2-7b", "generate", knobs))
        assert rec["status"] == "ok", rec["metrics"]
        nums = [v for v in rec["metrics"].values() if isinstance(v, (int, float))]
        assert nums and all(math.isfinite(v) for v in nums)
        assert rec["metrics"]["time_s"] > 0


# ---------------------------------------------------------------------------
# multi_board_zmq
# ---------------------------------------------------------------------------


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _ref_board_metrics(knobs):
    """The reference example's board: its md5 stand-in build, evaluated by
    the reference's ``JClient``."""
    from repro.core import JClient, JConfig, tpu_pod_space
    from repro.core.jconfig import TestConfig
    from repro.roofline.analysis import Artifact

    def build(tc):
        h = int(hashlib.md5(str(sorted(tc.knobs.items())).encode()).hexdigest(), 16)
        return Artifact(flops_per_device=4e12 + (h % 7) * 1e11, bytes_per_device=2e10,
                        wire_bytes_per_device=2e8, collectives={}, arg_bytes=10 ** 9,
                        temp_bytes=10 ** 8, output_bytes=10 ** 6, n_devices=64), {}
    client = JClient(JConfig(tpu_pod_space(n_chips=64), n_chips=64), build, client_id=0)
    return client.evaluate(TestConfig(0, "toy", "train_4k", knobs))["metrics"]


def test_multi_board_zmq_metrics_equal_reference():
    pytest.importorskip("zmq")
    res, a, b = _free_ports(3)
    host = _example("multi_board_zmq").main(["--device", "cpu", "--cfg-ports", f"{a},{b}",
                                             "--res-port", str(res)])
    recs = host.store.records
    assert sorted(r.config_id for r in recs) == list(range(48))
    assert all(r.status == "ok" for r in recs)
    assert {r.client_id for r in recs} <= {0, 1}
    for r in recs:
        assert r.metrics == _ref_board_metrics(r.knobs), r.config_id
