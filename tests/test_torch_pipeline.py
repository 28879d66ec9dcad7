"""The port's collectives and multi-process launcher against the JAX package,
on 4 CPU processes under gloo.

* ``parallel.pipeline``: 4 stages, 8 microbatches of ``tanh(x @ w)``, equal
  to the reference's ``pipeline_apply`` on 4 forced host devices on the same
  inputs (numpy, seeded) at atol 1e-5, on every stage; ``bubble_fraction``.
* ``parallel.compress.psum_int8``: bitwise equal to the reference's inside
  ``shard_map`` on the same 4 shards, and within 0.1 of the exact sum's
  scale.
* ``launch.train`` under ``torchrun --nproc-per-node 4`` with ``--device
  cpu`` (gloo, ``ShardingPolicy(make_host_mesh(), sp=False)``): crashed by
  ``--fault-at``, resumed, its losses bitwise equal to an uninterrupted
  4-rank run's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.parallel.pipeline import bubble_fraction
from tests import _torch_dist_ranks as ranks
from tests.conftest import run_with_devices

N_STAGES, N_MICRO, MB, D = 4, 8, 2, 16

_REF = """
import sys, jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import _make
from repro.parallel.compress import psum_int8
from repro.parallel.pipeline import pipeline_apply

d = np.load(sys.argv[1])
mesh = _make((4,), ("pipe",))
out = pipeline_apply(mesh, "pipe", lambda w, x: jnp.tanh(x @ w), jnp.asarray(d["ws"]),
                     jnp.asarray(d["xs"]))
dmesh = _make((4,), ("data",))
f = shard_map(lambda x: psum_int8(x[0], "data"), mesh=dmesh, in_specs=P("data"), out_specs=P())
np.savez(sys.argv[2], pipeline=np.asarray(out), psum_int8=np.asarray(f(jnp.asarray(d["shards"]))))
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(0)
    return {"ws": (rng.standard_normal((N_STAGES, D, D)) * 0.5).astype(np.float32),
            "xs": rng.standard_normal((N_MICRO, MB, D)).astype(np.float32),
            "shards": rng.standard_normal((4, 128)).astype(np.float32)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    out = run_with_devices(_REF.replace("sys.argv[1]", repr(str(tmp / "in.npz")))
                           .replace("sys.argv[2]", repr(str(tmp / "ref.npz"))),
                           n_devices=4, timeout=300)
    assert "REF_OK" in out
    ref = dict(np.load(tmp / "ref.npz"))
    return ref, inputs, ranks.spawn(ranks.collective_checks, inputs, world=4)


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
    assert bubble_fraction(1, 8) == 0.0


def test_pipeline_matches_reference_on_every_stage(results):
    ref, inputs, got = results
    seq = inputs["xs"]
    for s in range(N_STAGES):
        seq = np.tanh(seq @ inputs["ws"][s])
    for out in got["pipeline"]:
        np.testing.assert_allclose(out, ref["pipeline"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(out, seq, atol=1e-5, rtol=0)


def test_psum_int8_bitwise_equal_to_reference(results):
    ref, inputs, got = results
    for out in got["psum_int8"]:
        assert out.dtype == np.float32
        assert np.array_equal(out.view(np.uint32), ref["psum_int8"].view(np.uint32))
    exact = inputs["shards"].sum(axis=0)
    err = np.abs(got["psum_int8"][0] - exact).max()
    assert err < 0.1 * np.abs(exact).max()


def _torchrun(ck, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
           "--master-port", str(ranks.free_port()), "-m", "repro_torch.launch.train",
           "--arch", "tinyllama-1.1b", "--reduced", "--batch", "4", "--seq", "32",
           "--steps", "8", "--save-every", "3", "--log-every", "1", "--device", "cpu",
           "--checkpoint-dir", str(ck), *extra]
    env = dict(os.environ, PYTHONPATH=os.path.join(ranks.REPO, "src"), OMP_NUM_THREADS="1")
    return subprocess.run(cmd, env=env, cwd=ranks.REPO, capture_output=True, text=True,
                          timeout=300)


def _losses(stdout):
    import re

    return {int(m.group(1)): m.group(2)
            for m in re.finditer(r"\[train\] step +(\d+) loss \S+ \((\S+)\)", stdout)}


def test_train_cli_under_torchrun_crash_and_resume_bit_exact(tmp_path):
    straight = _torchrun(tmp_path / "straight")
    assert straight.returncode == 0, straight.stderr[-3000:]
    assert "[train] world 4: ShardingPolicy over ('data',) 4" in straight.stdout
    crash = _torchrun(tmp_path / "ck", "--fault-at", "5")
    assert crash.returncode != 0 and "[train] injected fault at step 5" in crash.stdout
    resumed = _torchrun(tmp_path / "ck")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "[train] resumed from step 3" in resumed.stdout
    want, got = _losses(straight.stdout), _losses(resumed.stdout)
    assert sorted(want) == list(range(1, 9)) and sorted(got) == list(range(4, 9))
    assert all(got[s] == want[s] for s in got)                  # float.hex: bitwise
    before = _losses(crash.stdout)
    assert sorted(before) == [1, 2, 3, 4, 5] and all(before[s] == want[s] for s in before)
