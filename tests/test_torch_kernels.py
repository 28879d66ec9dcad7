"""K3's plain PyTorch version against the JAX package's flash attention.

The same numpy inputs go through ``repro_torch.kernels.flash_attention`` on
the CPU (which takes the plain version), the JAX oracle
``repro.kernels.ref.flash_attention_ref`` and the Pallas kernel behind
``repro.kernels.ops.flash_attention`` (interpret mode on the CPU), on the
shape grid and at the tolerances of ``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


def _cast(arrs, dtype):
    if dtype == "bfloat16":
        return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("s,h,hkv,d,blk", [
    (64, 4, 4, 32, 16),      # MHA
    (128, 8, 2, 64, 32),     # GQA 4:1
    (96, 6, 1, 32, 32),      # MQA, non-block-multiple seq
    (128, 4, 4, 128, 64),    # MXU-width head dim
])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_and_pallas(s, h, hkv, d, blk, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _cast(_inputs(0, 2, s, h, hkv, d), dtype)
    got = fa.flash_attention(tq, tk, tv, causal=True, window=window,
                             block_q=blk, block_kv=blk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    want_ref = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    want_pallas = ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                      block_q=blk, block_kv=blk)
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(want_pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window,sq", [(False, 0, 40), (True, 0, 24), (True, 8, 24)])
def test_plain_noncausal_and_right_aligned(causal, window, sq):
    """The oracle's other modes: no causal mask, and Sq < Skv right-aligned."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal, window=window)
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
