"""K4's plain version and the port's Mamba-2 block against the JAX package, on the CPU.

The same numpy inputs go through ``repro_torch.kernels.ssd_scan`` (which
takes its plain version for CPU tensors), the Pallas kernel behind
``repro.kernels.ops.ssd_scan`` (interpret mode on the CPU) and the
sequential oracle ``repro.kernels.ref.ssd_ref``, at ``tests/test_kernels.py``'s
tolerance (1e-4).  The Mamba-2 block and its decode step are held against
``repro.models.mamba2`` on reduced mamba2-780m in fp32 at 5e-5
(``tests/test_prefill_decode.py``'s tolerance); in bf16 the decode's type
promotion is held against JAX's, at one bf16 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.kernels import ops, ref
from repro.models import mamba2 as jmamba
from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ssd_scan as k4
from repro_torch.models import mamba2
from repro_torch.models.convert import flatten, to_tensor

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=5e-5, rtol=5e-5)


def _ssd_inputs(seed, b, s, h, p, n):
    """x, a_log, b, c, dt as tests/test_kernels.py draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (-dt / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)
    bb = (0.4 * rng.standard_normal((b, s, n))).astype(np.float32)
    cc = (0.4 * rng.standard_normal((b, s, n))).astype(np.float32)
    return x, a_log, bb, cc, dt


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("s,h,p,n,chunk", [
    (64, 2, 16, 16, 16),
    (96, 4, 32, 32, 32),     # non-power-of-two chunks count
    (40, 1, 16, 64, 16),     # padding path (40 % 16 != 0)
    (70, 2, 64, 128, 32),    # mamba2-780m's head and state dims, ragged
    (20, 3, 16, 16, 256),    # the chunk clamped to next_pow2(S) = 32
])
def test_plain_matches_pallas_and_ref(s, h, p, n, chunk):
    arrs = _ssd_inputs(s, 2, s, h, p, n)
    before = k4.ssd_scan.launches
    y, state = k4.ssd_scan(*map(torch.from_numpy, arrs), chunk=chunk)
    assert k4.ssd_scan.launches == before          # the CPU takes the plain version
    assert y.shape == (2, s, h, p) and state.shape == (2, h, p, n)
    assert state.dtype == torch.float32
    jarrs = list(map(jnp.asarray, arrs))
    y_pl, state_pl = ops.ssd_scan(*jarrs, chunk=chunk)
    y_ref, state_ref = ref.ssd_ref(*jarrs)
    for want_y, want_s in ((y_pl, state_pl), (y_ref, state_ref)):
        np.testing.assert_allclose(_np(y), _np(want_y), **TOL)
        np.testing.assert_allclose(_np(state), _np(want_s), **TOL)


@pytest.mark.parametrize("s,chunk", [(64, 16), (45, 16), (7, 8), (20, 256)])
def test_ssd_chunked_matches_reference(s, chunk):
    """The port's plain chunked path against the reference's, padding included."""
    arrs = _ssd_inputs(100 + s, 2, s, 3, 16, 32)
    got = mamba2.ssd_chunked(*map(torch.from_numpy, arrs), chunk)
    want = jmamba.ssd_chunked(*map(jnp.asarray, arrs), chunk)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **TOL)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), **TOL)


def _mamba_pair(seed, dtype=jnp.float32):
    jcfg = jreduced(jget_arch("mamba2-780m"))
    cfg = reduced(get_arch("mamba2-780m"))
    params = jmamba.mamba_init(jax.random.key(seed), jcfg, dtype)
    # a non-trivial A_log, D and dt_bias, so their fp32 paths are exercised
    rng = np.random.default_rng(seed)
    h = cfg.n_ssm_heads
    params = dict(params, A_log=jnp.asarray(rng.uniform(-1, 1, h), jnp.float32),
                  D=jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32),
                  dt_bias=jnp.asarray(rng.uniform(-1, 0.5, h), jnp.float32))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    mod = mamba2.Mamba(cfg, tdtype, "cpu")
    mod.load_state_dict({k: to_tensor(v) for k, v in
                         flatten(jax.tree.map(np.asarray, params))})
    return jcfg, cfg, params, mod


@pytest.mark.parametrize("impl,jimpl", [("jnp", "jnp"), ("cuda", "pallas")])
@pytest.mark.parametrize("s", [16, 13])
def test_mamba_block_matches_reference(impl, jimpl, s):
    jcfg, cfg, params, mod = _mamba_pair(0)
    assert mod.A_log.dtype == mod.D.dtype == mod.dt_bias.dtype == torch.float32
    x = np.random.default_rng(1).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want, wcache = jmamba.mamba_block(params, jnp.asarray(x), jcfg, impl=jimpl)
    got, cache = mamba2.mamba_block(mod, torch.from_numpy(x), cfg, impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(_np(cache[name]), _np(wcache[name]), **MODEL_TOL)


def test_mamba_decode_matches_reference():
    jcfg, cfg, params, mod = _mamba_pair(2)
    rng = np.random.default_rng(3)
    b = 3
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    empty = mamba2.empty_mamba_cache(cfg, b, "cpu")
    cache = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in empty.items()}
    want, wcache = jmamba.mamba_decode(params, jnp.asarray(x),
                                       {k: jnp.asarray(v) for k, v in cache.items()}, jcfg)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gcache = mamba2.mamba_decode(mod, torch.from_numpy(x), tcache, cfg)
    assert gcache is tcache                         # written into the dict it was given
    np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(_np(gcache[name]), _np(wcache[name]), **MODEL_TOL)


@pytest.mark.parametrize("conv_dtype", ["bfloat16", "float32"], ids=["engine", "slot_server"])
def test_bf16_decode_promotes_as_jax(conv_dtype):
    """A bf16 model decodes against prefill's bf16 conv (Engine) or the
    shared fp32 conv (SlotServer): the new cache keeps JAX's promoted types,
    and the outputs agree within one bf16 rounding."""
    jcfg, cfg, params, mod = _mamba_pair(4, dtype=jnp.bfloat16)
    rng = np.random.default_rng(5)
    b = 2
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((b, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    conv = rng.standard_normal((b, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state))
    jconv = jnp.asarray(conv, getattr(jnp, conv_dtype))
    want, wcache = jmamba.mamba_decode(
        params, jnp.asarray(x, jnp.bfloat16),
        {"state": jnp.asarray(state, jnp.float32), "conv": jconv}, jcfg)
    tcache = {"state": torch.tensor(state, dtype=torch.float32),
              "conv": torch.from_numpy(np.array(jconv.astype(jnp.float32))).to(
                  getattr(torch, conv_dtype))}
    got, gcache = mamba2.mamba_decode(mod, torch.from_numpy(x).to(torch.bfloat16), tcache, cfg)
    assert got.dtype == torch.bfloat16
    assert str(gcache["conv"].dtype).split(".")[-1] == str(wcache["conv"].dtype)
    assert gcache["state"].dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(gcache["state"]), _np(wcache["state"]), atol=2e-2, rtol=2e-2)
