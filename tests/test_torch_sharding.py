"""The port's sharding policy and sharded paths against the JAX package.

* Rules (one process): ``param_spec``, ``cache_spec`` (batch 128 and the
  batch-1 fold of ``long_500k``), ``batch_spec`` and ``moe_groups`` equal
  the reference's ``ShardingPolicy`` for every leaf of every registered
  arch at full width (the port's on ``meta``, the reference's on
  ``eval_shape``), with and without FSDP, on the host (1,), (2, 4),
  (16, 16) and (2, 16, 16) meshes: the reference's side takes
  ``jax.sharding.AbstractMesh``, the port's a ``launch.mesh.MeshShape``.
  A port layer's weight is held against the reference's stacked leaf of its
  layer group, whose leading group axis is never sharded.
* Sharded paths (4 processes under gloo, one spawn for the whole file,
  ``torch.set_num_threads(1)`` in each rank; ``tests/_torch_dist_ranks.py``):
  reduced tinyllama-1.1b in fp32 on a (2, 2) ``(data, model)`` mesh with
  SP, four train steps from the reference's weights (``params_from_jax``)
  on the reference's ``SyntheticLM`` batches, against the reference's
  single-device losses and grad norms at rtol 2e-4
  (``tests/test_sharding.py``'s tolerance) and weights after the steps,
  with AdamW and with Adafactor plus ``grad_rs``; grouped MoE (reduced
  deepseek-moe-16b, g = 2) equal to g = 1 at capacity factor 4 and, at
  the default capacity where tokens drop, to the reference's grouped loss
  on a (2, 4) mesh, both at rtol 1e-5; a grouped MoE train step at dp = 2
  with the experts over model: every gradient, then three steps' losses,
  grad norms and weights against the reference's grouped step; reduced
  mamba2-780m's gradients against the reference's single device, with the
  mixer on each rank's H/2 heads and no rank computing with a whole
  ``wz``, ``wx`` or ``out_proj``; reduced mamba2-780m's and
  jamba-v0.1-52b's prefill and three decode steps under the policy against
  the reference's single device, the caches in ``cache_spec``'s
  placements; a 6-head Mamba-2 on a (1, 4) mesh, whose heads the model
  axis does not divide (gradients, prefill and decode); flash prefills (K3 on each rank's block) with SP off, with
  SP on, and with glm4-9b's split q heads beside whole kv heads on a
  (1, 4) mesh, against the reference's flash prefill; reduced glm4-9b decode
  steps with the caches placed by ``cache_spec`` at batch 4 and 1, the
  logits equal to the unsharded steps' at 2e-5, inside
  ``tests/test_torch_models.py``'s fp32 tolerance (5e-5); a sharded state's checkpoint equal file for file to the
  single-device one at equal weights, and the next step after restoring
  it into the placements giving the loss bit for bit.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.data import device_put_batch
from repro.models import BuildFlags as JFlags, Model as JModel
from repro.parallel.sharding import ShardingPolicy as JPolicy
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import SHAPES, get_arch, list_archs, reduced
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import BuildFlags, Model
from repro_torch.models.convert import layer_prefixes, params_from_jax, reference_path
from repro_torch.parallel.sharding import ShardingPolicy
from tests import _torch_dist_ranks as ranks
from tests.conftest import run_with_devices

MESHES = [((1,), ("data",)), ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["host", "2x4", "16x16", "2x16x16"]
# tests/test_torch_train.py's tolerances for gradients and for the weights
# after train steps (see there why AdamW's steps need STEP_PARAM_TOL)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
STEP_PARAM_TOL = dict(atol=2e-3, rtol=0)


def _norm(spec, ndim):
    """A spec as ``ndim`` entries, one-name tuples as the name (``PartitionSpec``
    canonicalises them so)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf.shape
            for path, leaf in flat}


@pytest.fixture(scope="module")
def full_width():
    """Per arch: (port model on meta, reference param shapes by path)."""
    out = {}
    for name in list_archs():
        jm = JModel(jget_arch(name), JFlags())
        out[name] = (Model(get_arch(name), BuildFlags(), device="meta", seed=None),
                     _ref_leaves(jm.init_shapes()), jm)
    return out


def _port_by_ref_path(model):
    prefixes = layer_prefixes(model.cfg)
    by = {}
    for name, p in model.named_parameters():
        by.setdefault(reference_path(name, prefixes), []).append((name, tuple(p.shape)))
    return by


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_param_specs_equal_reference(mesh, fsdp, full_width):
    sizes, names = mesh
    policy = ShardingPolicy(MeshShape(sizes, names), fsdp=fsdp)
    ref = JPolicy(AbstractMesh(sizes, names), fsdp=fsdp)
    n_leaves = 0
    for arch, (model, ref_leaves, _) in full_width.items():
        port = _port_by_ref_path(model)
        assert sorted(port) == sorted(ref_leaves), arch
        specs = policy.param_specs(model)
        for path, ref_shape in ref_leaves.items():
            want = _norm(ref.param_spec(path, ref_shape), len(ref_shape))
            for name, shape in port[path]:
                stacked = len(ref_shape) == len(shape) + 1
                assert ref_shape[len(ref_shape) - len(shape):] == shape, (arch, path)
                if stacked:
                    assert want[0] is None
                got = _norm(specs[name], len(shape))
                assert got == want[1:] if stacked else got == want, (arch, name, got, want)
                n_leaves += 1
    assert n_leaves > 1000


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_cache_specs_equal_reference(mesh, shape, full_width):
    sizes, names = mesh
    policy = ShardingPolicy(MeshShape(sizes, names))
    ref = JPolicy(AbstractMesh(sizes, names))
    b, s = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    for arch, (model, _, jm) in full_width.items():
        ref_leaves = _ref_leaves(jax.eval_shape(lambda: jm.empty_caches(b, s)))
        got = {}
        for prefix, cache in zip(layer_prefixes(model.cfg), model.empty_caches(b, s)):
            for key, t in cache.items():
                got.setdefault(f"{prefix}/{key}", []).append(tuple(t.shape))
        assert sorted(got) == sorted(ref_leaves), arch
        for path, ref_shape in ref_leaves.items():
            want = _norm(ref.cache_spec(path, ref_shape), len(ref_shape))
            for shp in got[path]:
                lead = len(ref_shape) - len(shp)
                assert want[:lead] == (None,) * lead
                assert _norm(policy.cache_spec(path, shp), len(shp)) == want[lead:], (arch, path)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_spec_and_moe_groups_equal_reference(mesh):
    sizes, names = mesh
    policy = ShardingPolicy(MeshShape(sizes, names))
    ref = JPolicy(AbstractMesh(sizes, names))
    for b in (1, 2, 4, 6, 8, 32, 128, 256, 512):
        for shp in ((b,), (b, 4096), (b, 576, 4096)):
            assert _norm(policy.batch_spec(shp), len(shp)) == _norm(ref.batch_spec(shp), len(shp))
        assert policy.moe_groups(b) == ref.moe_groups(b)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    policy = ShardingPolicy(MeshShape((2, 4, 2), ("pod", "data", "model")))
    assert policy.placements((None, ("pod", "data"), "model")) == (Shard(1), Shard(1), Shard(2))
    assert policy.placements(()) == (Replicate(),) * 3
    assert policy.placements(("model", None)) == (Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="mesh's axis order"):
        policy.placements((("data", "pod"),))
    assert policy.shards((None, ("pod", "data"), "model")) == 16


# ---------------------------------------------------------------------------
# the sharded paths, 4 ranks under gloo
# ---------------------------------------------------------------------------


def _jax_losses(opt_name, steps=ranks.TRAIN_STEPS):
    name = "tinyllama-1.1b"
    jm = JModel(jreduced(jget_arch(name)), JFlags(dtype="float32", remat="none", sp=False))
    jo = jopt.OPTIMIZERS[opt_name](jopt.cosine_schedule(1e-3, 2, 20))
    state = jinit_train_state(jm, jo, jax.random.key(0))
    params = jax.tree.map(np.asarray, state["params"])
    step = jax.jit(jmake_train_step(jm, jo))
    data = JSyntheticLM(jreduced(jget_arch(name)), JDataConfig(4, 32, 1))
    losses, gnorms = [], []
    for i in range(steps):
        state, m = step(state, device_put_batch(data.batch(i)))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return params, losses, gnorms, jax.tree.map(np.asarray, state["params"])


def _jax_moe_params():
    cfg = jreduced(jget_arch("deepseek-moe-16b"))
    jm = JModel(cfg, JFlags(dtype="float32", remat="none", sp=False))
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0)))


def _jax_mamba_grads():
    """Reduced mamba2-780m's weights, and the loss and gradients of one
    batch on the reference's single device."""
    cfg = jreduced(jget_arch("mamba2-780m"))
    jm = JModel(cfg, JFlags(dtype="float32", remat="none", sp=False))
    params = jm.init(jax.random.key(0))
    batch = device_put_batch(JSyntheticLM(cfg, JDataConfig(4, 32, 3)).batch(0))
    loss, grads = jax.value_and_grad(lambda p: jm.loss_fn(p, batch)[0])(params)
    return jax.tree.map(np.asarray, params), float(loss), jax.tree.map(np.asarray, grads)


def _jax_ssm_decode():
    """Reduced mamba2-780m and jamba-v0.1-52b (capacity factor 8, so that
    no token drops: the grouped dispatch under the policy then routes as
    one group) on the reference's single device: the weights, and the
    logits of a prefill of the first SSM_PROMPT tokens and of a decode step
    at each further position, the caches grown as its ``Engine`` grows
    them."""
    import dataclasses

    import jax.numpy as jnp

    tokens = np.random.default_rng(7).integers(
        0, 256, (4, ranks.SSM_PROMPT + ranks.SSM_STEPS)).astype(np.int32)
    params, cfgs, logits = {}, {}, {}
    for name in ("mamba2-780m", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(jreduced(jget_arch(name)), capacity_factor=8.0)
        jm = JModel(cfg, JFlags(dtype="float32"))
        p = jm.init(jax.random.key(0))
        out, caches = jm.prefill(p, {"tokens": jnp.asarray(tokens[:, :ranks.SSM_PROMPT])})
        caches = jax.tree_util.tree_map_with_path(
            lambda path, c: jnp.pad(c, [(0, 0)] * (c.ndim - 3) + [(0, ranks.SSM_STEPS)]
                                    + [(0, 0)] * 2)
            if str(path[-1].key) in ("k", "v") else c, caches)
        steps = [np.asarray(out)]
        for pos in range(ranks.SSM_PROMPT, tokens.shape[1]):
            out, caches = jm.decode_step(p, jnp.asarray(tokens[:, pos:pos + 1]), caches, pos)
            steps.append(np.asarray(out))
        params[name] = jax.tree.map(np.asarray, p)
        cfgs[name] = dataclasses.replace(reduced(get_arch(name)), capacity_factor=8.0)
        logits[name] = np.stack(steps)
    return tokens, params, cfgs, logits


def _jax_whole_heads(tokens):
    """Reduced mamba2-780m widened to 6 heads of 32 (d_inner 192) on the
    reference's single device: the weights, the loss and gradients of one
    batch, and the logits of a prefill and decode steps of ``tokens``."""
    import dataclasses

    import jax.numpy as jnp

    cfg = dataclasses.replace(jreduced(jget_arch("mamba2-780m")), ssm_expand=3, ssm_head_dim=32)
    jm = JModel(cfg, JFlags(dtype="float32", remat="none", sp=False))
    params = jm.init(jax.random.key(0))
    batch = device_put_batch(JSyntheticLM(cfg, JDataConfig(4, 32, 3)).batch(0))
    loss, grads = jax.value_and_grad(lambda p: jm.loss_fn(p, batch)[0])(params)
    out, caches = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :ranks.SSM_PROMPT])})
    steps = [np.asarray(out)]
    for pos in range(ranks.SSM_PROMPT, tokens.shape[1]):
        out, caches = jm.decode_step(params, jnp.asarray(tokens[:, pos:pos + 1]), caches, pos)
        steps.append(np.asarray(out))
    return (jax.tree.map(np.asarray, params), float(loss), jax.tree.map(np.asarray, grads),
            np.stack(steps))


def _jax_flash_prefill(name, params):
    """The reference's single-device flash prefill (its Pallas kernel in
    interpret mode) of the tokens ``_sharded_flash`` prefills."""
    import jax.numpy as jnp

    tokens = np.random.default_rng(5).integers(0, 256, (4, 16)).astype(np.int32)
    jm = JModel(jreduced(jget_arch(name)), JFlags(dtype="float32", attn_impl="flash"))
    return np.asarray(jm.prefill(params, {"tokens": jnp.asarray(tokens)})[0])


def _jax_glm_params():
    jm = JModel(jreduced(jget_arch("glm4-9b")), JFlags(dtype="float32"))
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0)))


_GROUPED_REF = """
import dataclasses, jax, numpy as np
from repro.configs import get_arch, reduced
from repro.models import BuildFlags, Model
from repro.parallel.sharding import ShardingPolicy
from repro.launch.mesh import make_mesh_dp_tp
from repro.data import DataConfig, SyntheticLM, device_put_batch
from repro.train import adamw, cosine_schedule, make_train_step

arch = reduced(get_arch("deepseek-moe-16b"))
batch = SyntheticLM(arch, DataConfig(batch=4, seq_len=16, seed=2)).batch(0)
policy = ShardingPolicy(make_mesh_dp_tp(2, 4), sp=False, fsdp=False)
m = Model(arch, BuildFlags(dtype="float32", remat="none", sp=False, fsdp=False), policy)
params = m.init(jax.random.key(0))
placed = device_put_batch(batch, policy)
loss, _ = m.loss_fn(params, placed)
print("GROUPED_LOSS", float(loss).hex())
grads = jax.jit(jax.grad(lambda p: m.loss_fn(p, placed)[0]))(params)
opt = adamw(cosine_schedule(1e-3, 2, 20))
state = {"params": params, "opt": opt.init(params), "step": np.zeros((), np.int32)}
step = jax.jit(make_train_step(m, opt))
losses, gnorms = [], []
for _ in range(%(steps)d):
    state, met = step(state, placed)
    losses.append(float(met["loss"]))
    gnorms.append(float(met["grad_norm"]))
flat = lambda tree, tag: {tag + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                          for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
np.savez(%(out)r, losses=np.array(losses), grad_norms=np.array(gnorms),
         **flat(grads, "grads:"), **flat(state["params"], "params:"))
"""


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    mamba_params, mamba_loss, mamba_grads = _jax_mamba_grads()
    ssm_tokens, ssm_params, ssm_cfgs, ssm_logits = _jax_ssm_decode()
    jobs = {"train": {}, "moe_params": _jax_moe_params(), "glm_params": _jax_glm_params(),
            "mamba_params": mamba_params, "tmp": str(tmp), "ssm_tokens": ssm_tokens,
            "ssm_params": ssm_params, "ssm_cfgs": ssm_cfgs}
    whole_params, whole_loss, whole_grads, whole_logits = _jax_whole_heads(ssm_tokens)
    jobs["whole_params"], jobs["whole_cfg"] = whole_params, _whole_cfg()
    ref = {}
    for opt_name in ("adamw", "adafactor"):
        params, losses, gnorms, final = _jax_losses(opt_name)
        jobs["train"][opt_name] = {"params": params}
        ref[opt_name] = {"losses": losses, "grad_norms": gnorms, "params": final}
    npz = str(tmp / "grouped_ref.npz")
    out = run_with_devices(_GROUPED_REF % {"steps": ranks.MOE_TRAIN_STEPS, "out": npz},
                           n_devices=8, timeout=300)
    grouped_ref_loss = float.fromhex(out.split("GROUPED_LOSS ")[1].split()[0])
    with np.load(npz) as z:
        grouped = {k: z[k] for k in z.files}
    flash_ref = {"tinyllama-1.1b": _jax_flash_prefill("tinyllama-1.1b",
                                                      jobs["train"]["adamw"]["params"]),
                 "glm4-9b": _jax_flash_prefill("glm4-9b", jobs["glm_params"])}
    return dict(ranks.spawn(ranks.sharding_checks, jobs, world=4), ref=ref,
                grouped_ref_loss=grouped_ref_loss, grouped_ref=grouped,
                mamba_ref={"loss": mamba_loss, "grads": mamba_grads},
                ssm_ref=ssm_logits, flash_ref=flash_ref,
                whole_ref={"loss": whole_loss, "grads": whole_grads, "logits": whole_logits})


def _tree(flat, tag):
    """The ``tag``-prefixed "/"-joined leaves of an npz as a nested dict."""
    from repro_torch.models.convert import unflatten

    return unflatten({k[len(tag):]: v for k, v in flat.items() if k.startswith(tag)})


def _params_close(got, want_tree, cfg):
    """After AdamW or Adafactor steps, every weight within STEP_PARAM_TOL and
    all but 0.1 % of them within PARAM_TOL of the reference's, the
    tolerances of ``tests/test_torch_train.py``'s train steps."""
    want = params_from_jax(want_tree, cfg)
    assert sorted(got) == sorted(want)
    off = total = 0
    for n, p in got.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), **STEP_PARAM_TOL, err_msg=n)
        d = (p - want[n]).abs()
        off += int((d > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want[n].abs()).sum())
        total += d.numel()
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("variant", ["adamw", "adafactor_grad_rs"])
def test_sharded_train_matches_reference_single_device(variant, dist_results):
    """Losses and grad norms per step at rtol 2e-4, and the parameters after
    the steps, against the reference's single device."""
    r = dist_results["train"][variant]
    ref = dist_results["ref"][variant.split("_")[0]]
    np.testing.assert_allclose(r["losses"], ref["losses"], rtol=2e-4)
    np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"], rtol=2e-4)
    _params_close(r["params"], ref["params"], reduced(get_arch("tinyllama-1.1b")))
    assert r["placements_ok"], r["placements"]
    assert r["steps"] == ranks.TRAIN_STEPS


def test_grouped_moe_matches_ungrouped_without_drops(dist_results):
    r = dist_results["moe"]
    assert r["groups"] == 2
    np.testing.assert_allclose(r["loss_g2_cf4"], r["loss_g1_cf4"], rtol=1e-5)


def test_grouped_moe_with_drops_matches_reference(dist_results):
    r = dist_results["moe"]
    assert r["dropped"] > 0
    np.testing.assert_allclose(r["loss_g2"], dist_results["grouped_ref_loss"], rtol=1e-5)
    # and it is not the ungrouped loss: the groups' capacities drop other tokens
    assert r["loss_g2"] != r["loss_g1"]


def test_grouped_moe_train_step_matches_reference(dist_results):
    """dp = 2, g = 2, experts over model, FSDP: every gradient (router and
    experts included) at GRAD_TOL, then the losses and grad norms of three
    AdamW steps at rtol 1e-5 and the parameters after them, against the
    reference's grouped step on a (2, 4) mesh."""
    r, ref = dist_results["moe_train"], dist_results["grouped_ref"]
    cfg = reduced(get_arch("deepseek-moe-16b"))
    assert "Shard(dim=0)" in r["expert_placements"], r["expert_placements"]
    np.testing.assert_allclose(r["loss"], dist_results["grouped_ref_loss"], rtol=1e-5)
    want = params_from_jax(_tree(ref, "grads:"), cfg)
    assert sorted(r["grads"]) == sorted(want)
    assert any(n.endswith("router") for n in want) and any("experts" in n for n in want)
    for n, g in r["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), **GRAD_TOL, err_msg=n)
    np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
    np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"], rtol=1e-5)
    _params_close(r["params"], _tree(ref, "params:"), cfg)


def test_sharded_mamba_gradients_match_reference(dist_results):
    """Reduced mamba2-780m on the (2, 2) mesh with SP and FSDP, the mixer on
    each data rank's rows and each model rank's heads: the loss at rtol
    1e-5 and every gradient at GRAD_TOL against the reference's single
    device."""
    r, ref = dist_results["mamba_grads"], dist_results["mamba_ref"]
    np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
    want = params_from_jax(ref["grads"], reduced(get_arch("mamba2-780m")))
    assert sorted(r["grads"]) == sorted(want)
    for n, g in r["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), **GRAD_TOL, err_msg=n)


def test_sharded_mamba_runs_each_ranks_heads(dist_results):
    """Every rank's scans saw H/2 heads (the (2, 2) mesh's model axis
    divides reduced mamba2-780m's 8), and no rank computed with a whole
    ``wz``, ``wx`` or ``out_proj``: their d_inner dimension is halved."""
    r = dist_results["mamba_grads"]
    cfg = reduced(get_arch("mamba2-780m"))
    di, d = cfg.d_inner, cfg.d_model
    assert len(r["scan_heads"]) == 4
    for heads, shares in zip(r["scan_heads"], r["shares"]):
        assert heads == [cfg.n_ssm_heads // 2] * cfg.n_layers
        assert shares == [{"wz": (d, di // 2), "wx": (d, di // 2),
                           "out_proj": (di // 2, d)}] * cfg.n_layers


def _whole_cfg():
    import dataclasses

    return dataclasses.replace(reduced(get_arch("mamba2-780m")), ssm_expand=3, ssm_head_dim=32)


def test_sharded_mamba_runs_all_heads_where_tp_does_not_divide_them(dist_results):
    """6 heads of 32 on a (1, 4) mesh: ``wx`` split over model through a
    head, every rank running all heads; the loss at rtol 1e-5, every
    gradient at GRAD_TOL and the prefill and decode logits within 1e-5 of
    the largest, against the reference's single device."""
    r, ref = dist_results["whole_heads"], dist_results["whole_ref"]
    assert r["heads"] == 1 and "Shard(dim=1)" in r["wx_placements"], r
    np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-5)
    want = params_from_jax(ref["grads"], _whole_cfg())
    assert sorted(r["grads"]) == sorted(want)
    for n, g in r["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), **GRAD_TOL, err_msg=n)
    np.testing.assert_allclose(r["logits"], ref["logits"], rtol=0,
                               atol=1e-5 * np.abs(ref["logits"]).max())


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_sharded_ssm_decode_matches_reference(arch, dist_results):
    """A prefill and three decode steps under the policy on the (2, 2)
    mesh (the Mamba-2 state's heads and the conv window's channels over
    model; jamba's attention layer against the sequence-sharded KV cache)
    against the reference's single-device prefill and decode: the logits
    of every step within 1e-5 of the largest |logit| (fp32), the caches in
    ``cache_spec``'s placements."""
    r, want = dist_results["ssm_decode"][arch], dist_results["ssm_ref"][arch]
    assert r["placements_ok"], r["placements"]
    assert any("Shard(dim=1)" in p for p in r["placements"])
    assert r["logits"].shape == want.shape == (1 + ranks.SSM_STEPS, 4, 256)
    np.testing.assert_allclose(r["logits"], want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_place_caches_refuses_a_cache_shorter_than_the_prompt(dist_results):
    """``ShardingPolicy.place_caches`` asked for a cache one position
    shorter than jamba's prompt raises, as ``serve.engine.pad_caches``
    does, rather than cropping the K/V; mamba2-780m's caches have no
    sequence axis and place as they are."""
    r = dist_results["ssm_decode"]
    msg = f"a {ranks.SSM_PROMPT}-position prompt does not fit a {ranks.SSM_PROMPT - 1}-slot cache"
    assert r["jamba-v0.1-52b"]["short_cache_error"] == msg
    assert r["mamba2-780m"]["short_cache_error"] is None


def test_sharded_flash_attention_runs_k3_on_blocks(dist_results):
    """K3 under every placement the reference's rules give, against the
    reference's single-device flash prefill: with SP off each rank's block
    (batch over data, heads over model); with SP on q's sequence gathered
    over model, all heads, against k/v whole; on glm4-9b's (1, 4) mesh each
    rank's q head beside the one kv head it uses."""
    r, ref = dist_results["flash"], dist_results["flash_ref"]
    n_attn = reduced(get_arch("tinyllama-1.1b")).n_layers
    assert r["sp_off"]["calls"] == [((2, 16, 2, 16), (2, 16, 1, 16), "Tensor")] * n_attn
    assert r["sp"]["calls"] == [((2, 16, 4, 16), (2, 16, 2, 16), "Tensor")] * n_attn
    n_glm = reduced(get_arch("glm4-9b")).n_layers
    assert r["glm_1x4"]["calls"] == [((4, 16, 1, 16), (4, 16, 1, 16), "Tensor")] * n_glm
    for label, arch in (("sp_off", "tinyllama-1.1b"), ("sp", "tinyllama-1.1b"),
                        ("glm_1x4", "glm4-9b")):
        np.testing.assert_allclose(r[label]["logits"], ref[arch], atol=2e-5, rtol=2e-5,
                                   err_msg=label)


@pytest.mark.parametrize("batch", [4, 1])
def test_decode_cache_seq_sharding(batch, dist_results):
    r = dist_results["decode"][batch]
    assert r["seq_sharded"], r["cache_placements"]
    np.testing.assert_allclose(r["sharded"], r["plain"], atol=2e-5, rtol=2e-5)


def test_sharded_checkpoint_equals_single_device_and_resumes(dist_results):
    r = dist_results["checkpoint"]
    assert r["files_equal"] and r["n_files"] > 10
    assert r["resumed_loss"] == r["next_loss"]      # bitwise


def test_sharded_paths_ran_k5_on_local_rows(dist_results):
    """K5's wrapper took each rank's local rows (plain CPU tensors here: on
    the card the same call launches the kernel)."""
    n_moe = sum(s.ffn == "moe" for s in reduced(get_arch("deepseek-moe-16b")).layer_specs())
    assert dist_results["moe"]["gating_rows"] == [ranks.MOE_BATCH * 16 // 2] * n_moe
