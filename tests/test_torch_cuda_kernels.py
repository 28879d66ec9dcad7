"""The CUDA kernels (K3; K1a, K1b, K2) against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc; where PyTorch sees no device
they skip (decided inside the fixture, so every worker collects the same
tests).  This file imports no JAX: the machine with the card has none.
Run it there with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances are those of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2;
a bf16 output is also held against the plain version in fp32 at one bf16
rounding (atol 1e-4, rtol 2**-8).  The GP kernels are float64: w, g and
the new rows of L and L⁻¹ within 1e-10 · max(1, max|ref|), EHVI within 1e-8
absolute (``tests/test_gp_pallas.py``'s gate), and two launches on the same
inputs bitwise equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import BuildFlags, Model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; PyTorch sees none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, s, h, hkv, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


@pytest.mark.parametrize("s,h,hkv,d", [
    (64, 4, 4, 32), (128, 8, 2, 64), (96, 6, 1, 32), (128, 4, 4, 128),
    (200, 4, 2, 16),          # ragged edge: 200 is not a tile multiple
    (1, 2, 1, 64),            # a single position
    (17, 32, 32, 128),        # llama2-7b heads, a partly filled q tile
])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_matches_plain(cuda, s, h, hkv, d, window, dtype):
    q, k, v = _qkv(cuda, 2, s, h, hkv, d, dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # The kernel computes in fp32: against the plain version in fp32 on
        # the same inputs it is off by one bf16 rounding of the output.
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=True, window=window)
        torch.testing.assert_close(got.float(), want32, atol=1e-4, rtol=2 ** -8)


def test_kernel_noncausal(cuda):
    q, k, v = _qkv(cuda, 1, 80, 4, 4, 64, torch.float32, seed=1)
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 2, 2, 48, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 2, 2, 32, torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 16, 2, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def test_flash_prefill_matches_xla_on_card(cuda):
    cfg = reduced(get_arch("tinyllama-1.1b"))
    flash = Model(cfg, BuildFlags(dtype="float32", attn_impl="flash"), device=cuda, seed=0)
    xla = Model(cfg, BuildFlags(dtype="float32", attn_impl="xla"), device=cuda, seed=0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    before = fa.flash_attention.launches
    with torch.inference_mode():
        lf, _ = flash.prefill({"tokens": toks})
        lx, _ = xla.prefill({"tokens": toks})
    assert fa.flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(lf, lx, atol=5e-5, rtol=5e-5)


# ---------------------------------------------------------------------------
# K1a, K1b, K2 (the GP tier's kernels) against their plain versions, float64
# ---------------------------------------------------------------------------


def _gp_case(dev, cap, n, m, d, ard, seed):
    """A real GP state on the card: n random rows factored by the torch tier,
    and an m-row block padded to its pow2 height B."""
    from repro_torch.core.search import gp_torch

    rng = np.random.default_rng(seed)
    ls = rng.uniform(0.5, 1.5, d) if ard else 0.3
    xb = torch.zeros((cap, d), dtype=torch.float64, device=dev)
    xb[:n] = torch.as_tensor(rng.random((n, d)), dtype=torch.float64, device=dev)
    lb, lib = gp_torch._refactor(xb, n, ls, 1e-3, 1.0)
    B = 1
    while B < m:
        B *= 2
    xnew = torch.zeros((B, d), dtype=torch.float64, device=dev)
    xnew[:m] = torch.as_tensor(rng.random((m, d)), dtype=torch.float64, device=dev)
    return ls, xb, lb, lib, xnew


def _rel(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.parametrize("cap,n,m,d,ard", [
    (64, 0, 7, 14, False),      # the first append
    (64, 48, 7, 14, False),     # n on a 16-row edge, B = 8
    (64, 17, 16, 5, True),      # just past an edge, ARD
    (8192, 6144, 512, 14, False),   # a 64-row edge, B = 512
    (8192, 6145, 7, 14, True),      # just past one, ARD
    (8192, 6250, 1, 14, False),     # the search path's active set, B = 1
])
def test_gp_append_kernels_match_plain(cuda, cap, n, m, d, ard):
    from repro_torch.core.search import gp_torch
    from repro_torch.kernels import gp_ops

    ls, xb, lb, lib, xnew = _gp_case(cuda, cap, n, m, d, ard, seed=cap + n + m)
    ils = None if not ard else torch.as_tensor(1.0 / ls, dtype=torch.float64, device=cuda)
    ls2 = 1.0 if ard else ls * ls
    xs = xb.clone()
    xs[n:n + xnew.shape[0]] = xnew
    xq = xnew if ils is None else xnew * ils
    xs = xs if ils is None else xs * ils
    before = (gp_ops.gp_w.launches, gp_ops.gp_g.launches)
    w = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
    w2 = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
    g = gp_ops.gp_g(w, lib, n)
    g2 = gp_ops.gp_g(w, lib, n)
    torch.cuda.synchronize()
    assert (gp_ops.gp_w.launches, gp_ops.gp_g.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(w, w2) and torch.equal(g, g2)       # bitwise repeatable
    assert _rel(w, gp_ops.gp_w_plain(lib, xs, xq, n, m, ls2=ls2, signal=1.0)) <= 1e-10
    assert _rel(g, gp_ops.gp_g_plain(w, lib, n)) <= 1e-10
    # the whole append (K1a, Schur block, K1b, slab writes) against the
    # torch tier's dense full-capacity append on copies of the same state
    bufs = [xb.clone(), lb.clone(), lib.clone()]
    ok = gp_ops.gp_append(*bufs, n, m, xnew, ils, 1e-3, ls2=ls2, signal=1.0)
    dense = [xb.clone(), lb.clone(), lib.clone()]
    ok_dense = gp_torch._append(*dense, n, m, xnew, ls, 1e-3, 1.0)
    assert ok and bool(ok_dense)
    B = xnew.shape[0]
    for got, want in zip(bufs[1:], dense[1:]):
        assert _rel(got[n:n + B], want[n:n + B]) <= 1e-10
        assert not got[n + m:].any() and not got[:, n + m:].any()


@pytest.mark.parametrize("cap,n,P,d,n_front,ard", [
    (64, 40, 512, 14, 1, False),        # S = 2
    (8192, 6250, 512, 14, 1, False),    # the search path, S = 2
    (8192, 6250, 512, 14, 100, True),   # S = 129, ARD
    (8192, 5000, 37, 5, 40, False),     # a pool that is not a warp multiple
])
def test_gp_ehvi_kernel_matches_plain(cuda, cap, n, P, d, n_front, ard):
    from repro_torch.kernels import gp_ops

    rng = np.random.default_rng(n + P + n_front)

    def t(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=cuda)

    xb = np.zeros((cap, d))
    xb[:n] = rng.random((n, d))
    alpha = np.zeros((cap, 2))
    alpha[:n] = rng.standard_normal((n, 2)) * 0.05
    front = np.sort(rng.random(n_front))
    F = 1
    while F < n_front:
        F *= 2
    x = np.concatenate([front, np.full(F - n_front, 1.2)])
    y = np.concatenate([1.0 - front, np.full(F - n_front, 1.0 - front[-1])])
    ref = np.array([1.2, 1.1])
    stair = np.stack([np.concatenate([[-np.inf], x]), np.concatenate([x, ref[:1]]),
                      np.concatenate([ref[1:], y])])
    ymd = np.array([[0.2, 0.3], [0.2, 0.3]])
    ils = t(1.0 / rng.uniform(0.5, 1.5, d)) if ard else None
    args = (t(xb), t(alpha), n, t(rng.random((P, d))), t(stair), t(ymd), ils)
    before = gp_ops.gp_ehvi.launches
    got = gp_ops.gp_fused_ehvi(*args, ls2=1.0 if ard else 0.09, signal=1.0)
    got2 = gp_ops.gp_fused_ehvi(*args, ls2=1.0 if ard else 0.09, signal=1.0)
    torch.cuda.synchronize()
    assert gp_ops.gp_ehvi.launches == before + 2
    assert torch.equal(got, got2)
    xq = args[3] if ils is None else args[3] * ils
    xs = args[0] if ils is None else args[0] * ils
    want = gp_ops.gp_ehvi_plain(xq, xs, args[1], n, args[4], args[5],
                                ls2=1.0 if ard else 0.09, signal=1.0)
    assert (got - want).abs().max().item() <= 1e-8
    assert (want > 0).any()


def test_gp_searcher_runs_through_the_kernels(cuda):
    from repro_torch.core import BayesOpt, tpu_pod_space
    from repro_torch.kernels import gp_ops

    space = tpu_pod_space(n_chips=256)
    algo = BayesOpt(space, seed=3, n_init=6, pool_size=64, strategy="ehvi", gp_mode="cuda")
    before = (gp_ops.gp_w.launches, gp_ops.gp_g.launches, gp_ops.gp_ehvi.launches)
    for _ in range(12):
        c = algo.ask(1)[0]
        x = space.encode(c)
        algo.tell(c, np.array([x[0] + 0.5 * x[1], 1.0 - x[0] + 0.3 * x[2]]))
    s = algo._gp.stats()
    assert s["cuda_appends"] > 0 and s["cuda_scores"] > 0
    assert (gp_ops.gp_w.launches - before[0], gp_ops.gp_g.launches - before[1],
            gp_ops.gp_ehvi.launches - before[2]) == (s["cuda_appends"], s["cuda_appends"],
                                                       s["cuda_scores"])
