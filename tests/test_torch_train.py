"""The port's training path against the JAX package, on the CPU at reduced size.

Weights come from the JAX ``Model.init`` and are carried across with
``repro_torch.models.convert``; batches come from both packages'
``SyntheticLM``, which must agree bit for bit.  Everything runs in fp32.
Tolerances: losses, the CE and the aux loss 1e-5 relative; gradients
1e-5 absolute plus 1e-4 relative; parameters after 5 optimizer steps on
the same gradients 1e-5 absolute plus 1e-4 relative; after 5 train steps
(the losses at 1e-5 relative, the gradient norms at 1e-4) every weight
within 2·lr and all but 0.1 % of them within 1e-5 plus 1e-4 relative (see
``STEP_PARAM_TOL``); the int8 error-feedback compression bitwise.  MoE routing goes through K5's plain version here (CPU tensors),
inside its autograd ``Function``, whose backward is also held against
``torch.autograd.gradcheck`` in float64 and against autograd through the
plain version, ties included.  Remat none / selective / full must give the
same losses and gradients bit for bit.  The crash/resume launcher
(``launch.train``) and a checkpoint the reference wrote are run end to end.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.models import BuildFlags as JFlags, Model as JModel
from repro.parallel import compress as jcompress
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import TrainStepConfig as JTrainStepConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch, reduced
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.kernels import topk_gating as k5
from repro_torch.launch import train as train_cli
from repro_torch.models import BuildFlags, Model
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.parallel import compress
from repro_torch.train import (CheckpointManager, TrainStepConfig, init_train_state,
                               load_train_state, make_train_step, optimizer)

LOSS_TOL = dict(atol=0, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
# AdamW's first steps move a weight by about lr whatever its gradient's size,
# so where a gradient sits at fp32 noise the two packages may step it apart:
# after 5 train steps every weight within 2·lr, and all but 0.1 % of them
# within PARAM_TOL
STEP_PARAM_TOL = dict(atol=2e-3, rtol=0)
FAMILIES = ["tinyllama-1.1b", "deepseek-moe-16b", "llava-v1.5-7b", "musicgen-medium"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, remat="none", seed=0, **flag_kw):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg = jreduced(jget_arch(name))
    jm = JModel(jcfg, JFlags(dtype="float32", remat=remat, sp=False, **flag_kw))
    params = jm.init(jax.random.key(seed))
    cfg = reduced(get_arch(name))
    tm = Model(cfg, BuildFlags(dtype="float32", remat=remat, sp=False, **flag_kw),
               device="cpu", seed=None)
    tm.load_state_dict(params_from_jax(_np(params), cfg))
    return jm, params, tm


def _batches(name, step, batch=2, seq=16, seed=1):
    """The same step's batch from both packages' pipelines."""
    jb = JSyntheticLM(jreduced(jget_arch(name)), JDataConfig(batch, seq, seed)).batch(step)
    b = SyntheticLM(reduced(get_arch(name)), DataConfig(batch, seq, seed)).batch(step)
    return jax.tree.map(jnp.asarray, jb), b


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               **tol)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "internvl2-2b", "musicgen-medium",
                                  "llava-v1.5-7b"])
def test_synthetic_batches_bit_identical(name):
    for step in (0, 3, 17):
        jb, b = _batches(name, step, batch=3, seq=12, seed=9)
        assert sorted(jb) == sorted(b)
        for key in b:
            assert b[key].dtype == np.asarray(jb[key]).dtype, key
            np.testing.assert_array_equal(b[key], np.asarray(jb[key]))


def test_to_device_keeps_embeddings_and_widens_ids():
    _, b = _batches("llava-v1.5-7b", 0)
    t = to_device(b, "cpu")
    assert t["tokens"].dtype == t["labels"].dtype == torch.int64
    assert t["image_embeds"].dtype == torch.float32
    np.testing.assert_array_equal(t["tokens"].numpy(), b["tokens"])


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_matches_reference(name):
    jm, params, tm = _pair(name)
    jb, b = _batches(name, 0)
    want, wm = jm.loss_fn(params, jb)
    with torch.no_grad():
        got, m = tm.loss_fn(to_device(b, "cpu"))
    _close(got, want, LOSS_TOL)
    _close(m["ce"], wm["ce"], LOSS_TOL)
    _close(m["aux"], wm["aux"], LOSS_TOL)
    assert (float(wm["aux"]) > 0) == (name == "deepseek-moe-16b")


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_loss_matches_reference(chunks):
    jm, params, tm = _pair("tinyllama-1.1b", loss_chunks=chunks)
    jb, b = _batches("tinyllama-1.1b", 2)
    b["labels"] = b["labels"].copy()      # a view of the tokens' array
    b["labels"][0, :5] = -1                  # masked positions
    jb = dict(jb, labels=jnp.asarray(b["labels"]))
    want, _ = jm.loss_fn(params, jb)
    got, _ = tm.loss_fn(to_device(b, "cpu"))
    _close(got, want, LOSS_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_reference(name):
    """Every parameter's gradient, the MoE router's (through K5's plain
    version and the aux loss) included."""
    jm, params, tm = _pair(name, remat="selective")
    jb, b = _batches(name, 1)
    wgrads = jax.grad(lambda p: jm.loss_fn(p, jb)[0])(params)
    want = params_from_jax(_np(wgrads), tm.cfg)
    tm.requires_grad_(True)
    loss, _ = tm.loss_fn(to_device(b, "cpu"))
    names = [n for n, _ in tm.named_parameters()]
    # an audio arch never reads its token embeddings: a zero gradient, as jax.grad's
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        _close(g, want[n], GRAD_TOL)
    if name == "deepseek-moe-16b":
        routers = [n for n in names if n.endswith("router")]
        assert routers and all(want[n].abs().max().item() > 0 for n in routers)


def _logits(seed, t, e, ties, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal((t, e))
    if ties:
        x = np.round(x * 2) / 2
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("t,e,k", [(5, 8, 3), (3, 4, 4), (7, 16, 1)])
def test_topk_gating_backward_gradcheck(t, e, k):
    x = _logits(t * e + k, t, e, ties=False, dtype=torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda z: k5.topk_gating(z, k)[0], (x,))


@pytest.mark.parametrize("ties", [False, True])
def test_topk_gating_backward_matches_plain_autograd(ties):
    """The Function's backward against autograd through the plain version
    (softmax, then a stable sort), at the trainer's E = 64, k = 6 shape."""
    x = _logits(3, 96, 64, ties)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((96, 6)).astype(np.float32))
    a = x.clone().requires_grad_(True)
    p, ids = k5.topk_gating(a, 6)
    (p * g).sum().backward()
    b = x.clone().requires_grad_(True)
    want_p, want_ids = k5.topk_gating_plain(b, 6)
    (want_p * g).sum().backward()
    assert torch.equal(ids, want_ids) and ids.grad_fn is None and not ids.requires_grad
    torch.testing.assert_close(a.grad, b.grad, atol=1e-7, rtol=1e-6)


def test_topk_gating_without_grad_stays_outside_autograd():
    x = _logits(5, 10, 8, False).requires_grad_(True)
    with torch.no_grad():
        p, _ = k5.topk_gating(x, 2)
    assert p.grad_fn is None
    with torch.inference_mode():
        p, _ = k5.topk_gating(x.detach(), 2)
    assert p.grad_fn is None


class _CountProducts(TorchDispatchMode):
    """Counts the plain matrix products (``aten.mm``) dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def _loss_and_grads(tm, batch):
    tm.requires_grad_(True)
    with _CountProducts() as count:
        loss, m = tm.loss_fn(batch)
        forward_mm = count.mm
        grads = torch.autograd.grad(loss, list(tm.parameters()), allow_unused=True,
                                    materialize_grads=True)
    return [loss, m["aux"]] + list(grads), count.mm - 3 * forward_mm


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "deepseek-moe-16b", "jamba-v0.1-52b"])
def test_remat_modes_bitwise_equal(name, monkeypatch):
    """none / selective / full: the same loss, aux and gradients bit for bit.
    With remat, the MoE forward (and so K5) runs again in the backward pass."""
    calls = []
    real = moe.topk_gating

    def counted(logits, k):
        calls.append(logits.shape)
        return real(logits, k)
    monkeypatch.setattr(moe, "topk_gating", counted)
    _, b = _batches(name, 2)
    batch = to_device(b, "cpu")
    out, n_calls, recomputed_mm = {}, {}, {}
    for remat in ("none", "selective", "full"):
        _, _, tm = _pair(name, remat=remat)
        calls.clear()
        out[remat], recomputed_mm[remat] = _loss_and_grads(tm, batch)
        n_calls[remat] = len(calls)
    for remat in ("selective", "full"):
        for a, b_ in zip(out["none"], out[remat]):
            assert torch.equal(a, b_), remat
    n_moe = sum(1 for s in tm.cfg.layer_specs() if s.ffn == "moe")
    assert n_calls == {"none": n_moe, "selective": 2 * n_moe, "full": 2 * n_moe}
    # a backward runs two products per forward one (dX and dW); the
    # selective policy keeps the products' outputs, full remat runs them again
    assert recomputed_mm["none"] == recomputed_mm["selective"] == 0 < recomputed_mm["full"]


def test_unknown_remat_raises():
    _, _, tm = _pair("tinyllama-1.1b", remat="some")
    _, b = _batches("tinyllama-1.1b", 0)
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(to_device(b, "cpu"))


# ---------------------------------------------------------------------------
# optimizers, schedule, clipping, compression
# ---------------------------------------------------------------------------


def _opt_tree(seed):
    """Params of each kind the optimizers treat apart: a factored matrix
    (both dims >= 128), a stacked factored one, a small matrix and a vector."""
    rng = np.random.default_rng(seed)
    shapes = {"big": (256, 128), "stacked": (2, 128, 160), "small": (64, 32), "vec": (48,)}
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    sched = jopt.cosine_schedule(1e-2, 2, 10)
    jo = jopt.OPTIMIZERS[name](sched)
    to = optimizer.OPTIMIZERS[name](optimizer.cosine_schedule(1e-2, 2, 10))
    jparams = jax.tree.map(jnp.asarray, _opt_tree(0))
    params = {k: torch.from_numpy(v.copy()) for k, v in _opt_tree(0).items()}
    jstate, state = jo.init(jparams), to.init(params)
    for step in range(5):
        grads = _opt_tree(10 + step)
        jparams, jstate = jo.update(jax.tree.map(jnp.asarray, grads), jstate, jparams, step)
        params, state = to.update({k: torch.from_numpy(v) for k, v in grads.items()},
                                  state, params, torch.tensor(step, dtype=torch.int32))
    for k in params:
        _close(params[k], jparams[k], PARAM_TOL)
    if name == "adamw":
        for slot in ("m", "v"):
            for k in params:
                _close(state[slot][k], jstate[slot][k], PARAM_TOL)
    else:
        assert sorted(state["slots"]["big"]) == ["vc", "vr"]
        assert sorted(state["slots"]["small"]) == ["v"]
        for k in params:
            for slot, val in state["slots"][k].items():
                _close(val, jstate["slots"][k][slot], PARAM_TOL)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 130])
def test_cosine_schedule_matches_reference(step):
    want = jopt.cosine_schedule(1.0, warmup=10, total=100, min_frac=0.1)(step)
    got = optimizer.cosine_schedule(1.0, warmup=10, total=100, min_frac=0.1)(step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = {k: v * 10 for k, v in _opt_tree(3).items()}
    want, wnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    got, norm = optimizer.clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()},
                                              max_norm)
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
    for k in tree:
        _close(got[k], want[k], dict(atol=1e-7, rtol=1e-6))
    assert (optimizer.global_norm(got).item() <= max_norm * (1 + 1e-6)) or max_norm > norm


def test_ef_compression_matches_reference_bitwise():
    rng = np.random.default_rng(0)
    jef = jcompress.ef_init({"g": jnp.zeros((64,)), "m": jnp.zeros((8, 8))})
    ef = compress.ef_init({"g": torch.zeros(64), "m": torch.zeros((8, 8))})
    for _ in range(10):
        g = {"g": rng.standard_normal(64).astype(np.float32) * 0.1,
             "m": rng.standard_normal((8, 8)).astype(np.float32)}
        jout, jef = jcompress.ef_compress_tree(jax.tree.map(jnp.asarray, g), jef)
        out, ef = compress.ef_compress_tree({k: torch.from_numpy(v) for k, v in g.items()}, ef)
        for k in g:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(jef[k]))


def test_ef_compression_error_feedback():
    """The quantisation error is carried, not lost: the sum of compressed
    grads tracks the sum of true grads to one step's error."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64)
    comp_sum = np.zeros(64)
    ef = compress.ef_init({"g": torch.zeros(64)})
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64) * 0.1).float()
        true_sum += g.numpy()
        cg, ef = compress.ef_compress_tree({"g": g}, ef)
        comp_sum += cg["g"].numpy()
    assert np.abs(true_sum - comp_sum).max() < 0.05


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _port_train(name, tsc, opt_name="adamw", arch_name=None):
    _, params, tm = _pair(name, remat="selective")
    opt = optimizer.OPTIMIZERS[opt_name](optimizer.cosine_schedule(1e-3, 2, 20))
    state = init_train_state(tm, opt, tsc)
    return tm, state, make_train_step(tm, opt, tsc), params


@pytest.mark.parametrize("name,opt_name,tsc", [
    ("tinyllama-1.1b", "adamw", TrainStepConfig()),
    ("tinyllama-1.1b", "adafactor", TrainStepConfig()),
    ("deepseek-moe-16b", "adamw", TrainStepConfig(grad_compress=True)),
    ("internvl2-2b", "adamw", TrainStepConfig(microbatch=2)),
    ("glm4-9b", "adamw", TrainStepConfig()),
], ids=["adamw", "adafactor", "moe_compressed", "vision_microbatch", "glm4"])
def test_train_steps_match_reference(name, opt_name, tsc):
    """5 steps: losses, grad norms and the parameters after them."""
    jm, jparams, _ = _pair(name, remat="selective")
    jo = jopt.OPTIMIZERS[opt_name](jopt.cosine_schedule(1e-3, 2, 20))
    jtsc = JTrainStepConfig(microbatch=tsc.microbatch, grad_compress=tsc.grad_compress)
    jstate = jinit_train_state(jm, jo, jax.random.key(0), jtsc)
    jstate["params"] = jparams
    jstep = jax.jit(jmake_train_step(jm, jo, jtsc))
    tm, state, step, _ = _port_train(name, tsc, opt_name)
    for i in range(5):
        jb, b = _batches(name, i, batch=4)
        jstate, jmet = jstep(jstate, jb)
        state, met = step(state, to_device(b, "cpu"))
        _close(met["loss"], jmet["loss"], LOSS_TOL)
        _close(met["grad_norm"], jmet["grad_norm"], dict(atol=0, rtol=1e-4))
    assert int(state["step"]) == 5 and state["step"].dtype == torch.int32
    want = params_from_jax(_np(jstate["params"]), tm.cfg)
    off = total = 0
    for n, p in tm.named_parameters():
        assert p is state["params"][n]
        _close(p, want[n], STEP_PARAM_TOL)
        d = (p.detach() - want[n]).abs()
        off += int((d > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want[n].abs()).sum())
        total += d.numel()
    assert off <= 1e-3 * total, (off, total)


def test_microbatch_equivalence():
    """Grad accumulation over 2 and 4 microbatches matches the single-shot step."""
    _, b = _batches("tinyllama-1.1b", 0, batch=8, seq=32, seed=3)
    batch = to_device(b, "cpu")
    runs = {}
    for mb in (1, 2, 4):
        tm, state, step, _ = _port_train("tinyllama-1.1b", TrainStepConfig(microbatch=mb))
        state, met = step(state, batch)
        runs[mb] = (met["loss"].item(), [p.detach().clone() for p in tm.parameters()])
    for mb in (2, 4):
        np.testing.assert_allclose(runs[mb][0], runs[1][0], rtol=1e-5)
        for a, b_ in zip(runs[1][1], runs[mb][1]):
            torch.testing.assert_close(b_, a, atol=1e-5, rtol=0)


@pytest.mark.parametrize("opt_name,tsc", [("adamw", TrainStepConfig()),
                                          ("adafactor", TrainStepConfig()),
                                          ("adamw", TrainStepConfig(grad_compress=True))],
                         ids=["adamw", "adafactor", "compressed"])
def test_loss_decreases(opt_name, tsc):
    _, state, step, _ = _port_train("tinyllama-1.1b", tsc, opt_name)
    data = SyntheticLM(reduced(get_arch("tinyllama-1.1b")), DataConfig(8, 32, 3))
    losses = []
    for i in range(10):
        state, met = step(state, to_device(data.batch(i), "cpu"))
        losses.append(met["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("name", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_forward_and_train_step(name):
    """Every arch, as tests/test_archs_smoke.py: a finite loss, one train step,
    finite parameters that moved."""
    cfg = reduced(get_arch(name))
    model = Model(cfg, BuildFlags(dtype="float32", remat="selective", sp=False),
                  device="cpu", seed=0)
    batch = to_device(SyntheticLM(cfg, DataConfig(2, 24, 0)).batch(0), "cpu")
    with torch.no_grad():
        loss, _ = model.loss_fn(batch)
    assert loss.shape == () and torch.isfinite(loss)
    opt = optimizer.adamw(optimizer.cosine_schedule(1e-3, 0, 10))   # no warmup: lr > 0
    before = [p.detach().clone() for p in model.parameters()]
    state = init_train_state(model, opt)
    state, met = make_train_step(model, opt)(state, batch)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert int(state["step"]) == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _mk_state(seed=0):
    cfg = reduced(get_arch("tinyllama-1.1b"))
    model = Model(cfg, BuildFlags(dtype="float32", remat="none"), device="cpu", seed=seed)
    opt = optimizer.adamw(optimizer.cosine_schedule(1e-3, 5, 100))
    state = init_train_state(model, opt)
    data = SyntheticLM(cfg, DataConfig(4, 16, 7))
    return model, state, make_train_step(model, opt), data


def _flat(state):
    from repro_torch.train.checkpoint import _flatten

    return _flatten(state)


def _states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def test_checkpoint_roundtrip_exact(tmp_path):
    _, state, step, data = _mk_state()
    state, _ = step(state, to_device(data.batch(0), "cpu"))
    ck = CheckpointManager(str(tmp_path), async_save=False)
    ck.save(3, state, block=True)
    assert os.path.exists(tmp_path / "step_00000003" / "manifest.json")
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert manifest["step"] == 3 and "params/embed.table" in manifest["leaves"]
    _, fresh, _, _ = _mk_state(seed=1)
    load_train_state(fresh, ck.restore(3, fresh))
    _states_equal(state, fresh)


def test_checkpoint_bf16_leaves_roundtrip(tmp_path):
    state = {"w": torch.randn((4, 3)).to(torch.bfloat16), "step": torch.tensor(2)}
    ck = CheckpointManager(str(tmp_path), async_save=False)
    ck.save(1, state)
    got = ck.restore(1, state)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], state["w"])


def test_checkpoint_async_save(tmp_path):
    _, state, _, _ = _mk_state()
    ck = CheckpointManager(str(tmp_path), async_save=True)
    ck.save(1, state)
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken before save returns, so the state can change
    in place while the writer runs."""
    state = {"w": torch.ones(1000)}
    ck = CheckpointManager(str(tmp_path), async_save=True)
    ck.save(1, state)
    state["w"].mul_(5)
    ck.wait()
    assert torch.equal(ck.restore(1, state)["w"], torch.ones(1000))


def test_checkpoint_keep_k(tmp_path):
    _, state, _, _ = _mk_state()
    ck = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, state, block=True)
    assert ck.all_steps() == [3, 4]


def test_checkpoint_torn_write_invisible(tmp_path):
    _, state, _, _ = _mk_state()
    ck = CheckpointManager(str(tmp_path), async_save=False)
    ck.save(5, state, block=True)
    os.makedirs(str(tmp_path / ".tmp-step_00000009"))
    (tmp_path / ".tmp-step_00000009" / "partial.npy").write_bytes(b"junk")
    os.makedirs(str(tmp_path / "step_00000010"))      # no manifest: ignored too
    assert ck.all_steps() == [5]
    assert ck.latest_step() == 5


def test_crash_restart_bit_exact(tmp_path):
    """6 steps straight against 3 + restore into a fresh state + 3."""
    model_a, state_a, step_a, data = _mk_state()
    for i in range(6):
        state_a, _ = step_a(state_a, to_device(data.batch(i), "cpu"))
    _, state_b, step_b, _ = _mk_state()
    ck = CheckpointManager(str(tmp_path), async_save=False)
    for i in range(3):
        state_b, _ = step_b(state_b, to_device(data.batch(i), "cpu"))
    ck.save(3, state_b, block=True)
    _, state_c, step_c, _ = _mk_state(seed=5)
    load_train_state(state_c, ck.restore(ck.latest_step(), state_c))
    for i in range(3, 6):
        state_c, _ = step_c(state_c, to_device(data.batch(i), "cpu"))
    _states_equal(state_a, state_c)


# ---------------------------------------------------------------------------
# the launcher, and checkpoints crossing from the reference
# ---------------------------------------------------------------------------


def _train_argv(ckdir, *extra):
    return ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "4", "--seq", "32",
            "--steps", "12", "--save-every", "5", "--log-every", "1", "--device", "cpu",
            "--checkpoint-dir", str(ckdir), *extra]


def test_train_cli_crash_and_resume_bit_exact(tmp_path, capsys):
    straight = train_cli.main(_train_argv(tmp_path / "straight"))
    assert sorted(straight) == list(range(1, 13))
    with pytest.raises(SystemExit) as crash:
        train_cli.main(_train_argv(tmp_path / "ck", "--fault-at", "8"))
    assert crash.value.code == 42
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 5
    capsys.readouterr()
    resumed = train_cli.main(_train_argv(tmp_path / "ck"))
    out = capsys.readouterr().out
    assert "[train] resumed from step 5" in out
    assert sorted(resumed) == list(range(6, 13))
    assert all(resumed[s] == straight[s] for s in resumed)       # bitwise
    assert f"({straight[12].hex()})" in out
    assert not torch.are_deterministic_algorithms_enabled()     # restored after the run


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_cli.parse_args([]).device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced", "--steps", "1"])


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 3 steps and checkpoints; the port restores that
    checkpoint (through ``convert``) and its next 3 losses equal the
    reference's own next 3."""
    name = "deepseek-moe-16b"
    jm, jparams, tm = _pair(name, remat="selective")
    jo = jopt.adamw(jopt.cosine_schedule(1e-3, 2, 20))
    jstate = jinit_train_state(jm, jo, jax.random.key(0))
    jstate["params"] = jparams
    jstep = jax.jit(jmake_train_step(jm, jo))
    for i in range(3):
        jstate, _ = jstep(jstate, _batches(name, i, batch=4)[0])
    JCheckpointManager(str(tmp_path), async_save=False).save(3, jstate, block=True)
    want = []
    for i in range(3, 6):
        jstate, met = jstep(jstate, _batches(name, i, batch=4)[0])
        want.append(float(met["loss"]))

    cfg = reduced(get_arch(name))
    fresh = Model(cfg, BuildFlags(dtype="float32", remat="selective", sp=False),
                  device="cpu", seed=7)
    opt = optimizer.adamw(optimizer.cosine_schedule(1e-3, 2, 20))
    state = init_train_state(fresh, opt)
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_step() == 3
    load_train_state(state, ck.restore(3, state, cfg=cfg))
    assert int(state["step"]) == 3
    step = make_train_step(fresh, opt)
    got = []
    for i in range(3, 6):
        state, met = step(state, to_device(_batches(name, i, batch=4)[1], "cpu"))
        got.append(met["loss"].item())
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_train_state_from_jax_maps_adafactor_slots():
    jm, jparams, tm = _pair("tinyllama-1.1b")
    jo = jopt.adafactor(jopt.cosine_schedule(1e-3, 2, 20))
    jstate = {"params": jparams, "opt": jo.init(jparams), "step": jnp.zeros((), jnp.int32)}
    got = train_state_from_jax(_np(jstate), tm.cfg)
    names = {n for n, _ in tm.named_parameters()}
    assert set(got["params"]) == set(got["opt"]["slots"]) == names
    assert all(set(s) == {"v"} for s in got["opt"]["slots"].values())
