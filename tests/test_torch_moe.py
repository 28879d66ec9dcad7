"""K5's plain version and the port's MoE FFN against the JAX package, on the CPU.

The same numpy logits go through ``repro_torch.kernels.topk_gating`` (which
takes its plain version for CPU tensors), the Pallas kernel behind
``repro.kernels.ops.topk_gating`` (interpret mode on the CPU) and the oracle
``repro.kernels.ref.topk_gating_ref``: ids equal, ties included (the lower
expert index first), probabilities within 1e-6 (``tests/test_kernels.py``'s
tolerance).  ``moe_ffn`` is held against ``repro.models.moe.moe_ffn`` on
reduced deepseek-moe-16b in fp32 at 5e-5, with shared experts, and with a
capacity factor low enough that tokens are dropped; its Switch aux loss
at the same tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.kernels import ops, ref
from repro.models import moe as jmoe
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import topk_gating as k5
from repro_torch.models import moe
from repro_torch.models.convert import flatten, to_tensor

MODEL_TOL = dict(atol=5e-5, rtol=5e-5)


def _logits(seed, t, e, ties):
    x = np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)
    if ties:   # a coarse grid: many rows hold equal logits, so equal probabilities
        x = np.round(x * 2) / 2
    return x


@pytest.mark.parametrize("t,e,k,ties", [
    (1, 4, 2, False), (37, 16, 3, False), (200, 64, 6, False),   # deepseek: E 64, k 6
    (37, 4, 4, True), (129, 64, 6, True), (64, 16, 8, True), (33, 256, 8, False),
])
def test_plain_matches_pallas_and_ref(t, e, k, ties):
    x = _logits(t * e + k, t, e, ties)
    before = k5.topk_gating.launches
    p, ids = k5.topk_gating(torch.from_numpy(x), k)
    assert k5.topk_gating.launches == before       # the CPU takes the plain version
    assert p.shape == ids.shape == (t, k) and p.dtype == torch.float32
    assert ids.dtype == torch.int32
    for want_p, want_ids in (ops.topk_gating(jnp.asarray(x), k, block_t=64),
                             ref.topk_gating_ref(jnp.asarray(x), k)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p), atol=1e-6, rtol=0)


@pytest.mark.parametrize("t,k", [(1, 1), (37, 4), (256, 6), (33, 8)])
def test_out_buffers_are_two_contiguous_disjoint_outputs(t, k):
    """The CUDA wrapper's outputs: contiguous (T, k) fp32 and int32 tensors
    on the logits' device, neither overlapping the other."""
    p, ids = k5.out_buffers(torch.zeros((t, 16)), k)
    assert p.shape == ids.shape == (t, k)
    assert p.dtype == torch.float32 and ids.dtype == torch.int32
    assert p.device.type == ids.device.type == "cpu"
    assert p.is_contiguous() and ids.is_contiguous()
    p.fill_(0.5)
    ids.fill_(-1)
    assert torch.all(p == 0.5) and torch.all(ids == -1)


def test_ties_go_to_the_lower_index():
    x = torch.zeros((3, 8))
    x[1, 5] = x[1, 2] = 1.0
    x[2] = torch.tensor([0.0, 2.0, 1.0, 2.0, 1.0, 2.0, 0.0, 1.0])
    _, ids = k5.topk_gating(x, 4)
    assert ids.tolist() == [[0, 1, 2, 3], [2, 5, 0, 1], [1, 3, 5, 2]]


def test_rank_in_expert_matches_reference():
    ids = np.random.default_rng(0).integers(0, 8, 300).astype(np.int32)
    got = moe._rank_in_expert(torch.from_numpy(ids).long(), 8)
    want = jmoe._rank_in_expert(jnp.asarray(ids), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_tokens", [1, 4, 31, 256, 1000])
def test_expert_capacity_matches_reference(n_tokens):
    for name in ("deepseek-moe-16b", "jamba-v0.1-52b"):
        assert moe.expert_capacity(n_tokens, get_arch(name)) == jmoe.expert_capacity(
            n_tokens, jget_arch(name))


def _moe_pair(seed, **overrides):
    jcfg = jreduced(jget_arch("deepseek-moe-16b"), **overrides)
    cfg = reduced(get_arch("deepseek-moe-16b"), **overrides)
    params = jmoe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    mod = moe.MoE(cfg, torch.float32, "cpu")
    mod.load_state_dict({k: to_tensor(v) for k, v in
                         flatten(jax.tree.map(np.asarray, params))})
    return jcfg, cfg, params, mod


@pytest.mark.parametrize("capacity_factor,shared", [(1.25, 1), (0.5, 1), (0.3, 0)],
                         ids=["default", "drops", "drops_no_shared"])
def test_moe_ffn_matches_reference(capacity_factor, shared):
    jcfg, cfg, params, mod = _moe_pair(1, capacity_factor=capacity_factor,
                                       n_shared_experts=shared)
    assert mod.router.dtype == torch.float32
    assert hasattr(mod, "shared") == bool(shared)
    x = np.random.default_rng(2).standard_normal((3, 10, cfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_ffn(params, jnp.asarray(x), jcfg)
    got, aux = moe.moe_ffn(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **MODEL_TOL)
    # at the low capacity factors some assignments really are dropped
    h = torch.from_numpy(x).reshape(30, -1)
    logits = (h * torch.rsqrt((h * h).mean(-1, keepdim=True) + cfg.norm_eps)) @ mod.router
    _, ids = k5.topk_gating(logits, cfg.moe_top_k)
    rank = moe._rank_in_expert(ids.long().reshape(-1), cfg.n_experts)
    dropped = int((rank >= moe.expert_capacity(30, cfg)).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped


def test_moe_ffn_keeps_the_dtype_and_router_in_fp32():
    cfg = reduced(get_arch("deepseek-moe-16b"))
    mod = moe.MoE(cfg, torch.bfloat16, "cpu", torch.Generator().manual_seed(0))
    assert mod.router.dtype == torch.float32 and mod.experts.wo.dtype == torch.bfloat16
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, aux = moe.moe_ffn(mod, x.to(torch.bfloat16), cfg)
    assert aux.dtype == torch.float32
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.isfinite(out.float()).all()
