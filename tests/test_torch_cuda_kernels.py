"""The CUDA kernels (K3; K1a, K1b, K2; K4, K5; K6) against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc; where PyTorch sees no device
they skip (decided inside the fixture, so every worker collects the same
tests).  This file imports no JAX: the machine with the card has none.
Run it there with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances are those of ``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2;
a bf16 output is also held against the plain version in fp32 at one bf16
rounding (atol 1e-4, rtol 2**-8).  K3's bf16 path (tensor cores, TMA) is
also run across its tile and ring edges and twice on the same inputs,
which must agree bitwise; its fp32 path (three TF32 passes) the same way,
at 2e-5 against the plain version and against its mirror.  K4 (the SSD
scan): fp32 at 1e-4 (``tests/test_kernels.py``'s ``ssd`` tolerance); a
bf16 y at 2e-2 and its fp32 final state at 1e-4 (the bf16 path feeds its
fp32 intermediates to the tensor cores as bf16 high and low parts, the
fp32 path every operand as TF32 high and low parts), the bf16 path also
against the plain version in fp32 at one bf16 rounding, both against their
mirror, across chunks, odd chunks and head counts and every P and N, with
every SM's shared memory filled with NaN or inf before a launch, each call
counted once; the Python grid and block decode equal the C library's.  K5 (top-k
gating): ids equal, ties included, and probabilities within 1e-6; under
autograd, its plain-PyTorch backward within 1e-6 of autograd through the
plain version.  K4
and K5 launched twice on the same inputs are bitwise equal.  The GP
kernels are float64: w, g and the new rows of L and L⁻¹ within
1e-10 · max(1, max|ref|), EHVI within 1e-8 absolute
(``tests/test_gp_pallas.py``'s gate), and two launches on the same inputs
bitwise equal; K2 also at the row counts where its row splits are
cut.  K5 also runs on a side stream after a slow producer there, and the
raw stream accessor the wrappers use must give PyTorch's current stream.
K6 (decode attention on the cache): at the served shapes and the other
models' head counts, windows and dtypes, at per-slot positions (an int
position is refused; the model's decode step turns one into a (B,) tensor
for K6), the caches bitwise equal to the plain version's after both, the output at
the tolerances above against the plain version and within one rounding to
q's dtype of fp64 attention, bitwise equal across two launches, no host
synchronisation; a reduced deepseek-moe-16b SlotServer's decode logits
through K6 against the same server on K6's plain version.  The serving
decode step as one CUDA graph (``Model.decode_step``): reduced
deepseek-moe-16b, mamba2-780m and hybrid SlotServers give tokens and
logits bitwise equal to ``decode_step_eager``'s, with one capture and
every later step a replay; a second server captures anew; ``Engine``
captures once per ``generate`` and gives the eager path's tokens; with
tracing on, the MoE routing counters equal the eager path's step by
step.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import BuildFlags, Model
from repro_torch.models.attention import decode_attention_plain

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


@pytest.mark.parametrize("b,s,h,hkv,d,window,causal", [
    # the bf16 kernel's 64-row q tiles and 64-key K/V tiles (d = 128), and
    # its two-stage ring (S = 1000: 16 K/V tiles)
    (1, 63, 4, 4, 128, 0, True), (1, 64, 4, 4, 128, 0, True), (1, 65, 4, 4, 128, 0, True),
    (1, 127, 4, 4, 128, 0, True), (1, 128, 4, 4, 128, 0, True), (1, 129, 4, 4, 128, 0, True),
    (1, 1000, 4, 4, 128, 0, True),
    (2, 200, 32, 8, 128, 0, True),       # GQA 32/8
    (1, 1000, 4, 2, 128, 256, True),     # a window whose lower edge falls mid-tile
    (1, 200, 4, 4, 128, 0, False),       # no causal mask: every tile to S
    (2, 300, 4, 2, 16, 0, True),         # 128-key tiles, 32-byte swizzle
    (2, 300, 4, 2, 32, 40, True),        # 128-key tiles, 64-byte swizzle
    (2, 300, 4, 4, 64, 0, True),         # one 128-byte column chunk
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_bf16_tensor_core_kernel_across_tile_edges(cuda, b, s, h, hkv, d, window, causal,
                                                   dtype):
    """Both tensor-core paths across their tiles (fp32: 64-row q tiles,
    32-key K/V tiles at d >= 64 and 64-key tiles below, in a two-stage
    ring, each tile's keys split between two warp groups): bf16 against the
    plain version in bf16 and in fp32; fp32 at 2e-5 against the plain
    version and against its mirror (three TF32 passes in plain PyTorch)."""
    q, k, v = _qkv(cuda, b, s, h, hkv, d, dtype, seed=s + d)
    got = fa.flash_attention(q, k, v, causal=causal, window=window).float()
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        mirror = fa.flash_attention_mirror_fp32(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, mirror, atol=2e-5, rtol=2e-5)
        return
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=causal, window=window)
    torch.testing.assert_close(got, want32, atol=1e-4, rtol=2 ** -8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_bf16_kernel_repeats_bitwise(cuda, dtype):
    q, k, v = _qkv(cuda, 2, 300, 8, 2, 128, dtype, seed=5)
    first = fa.flash_attention(q, k, v, window=100)
    again = fa.flash_attention(q, k, v, window=100)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


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
    # TMA reads from 16-byte boundaries only
    off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(off, k.bfloat16(), v.bfloat16())


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
    # the fold's 128-row tiles and the tell/fold switch (B = 8 | 16)
    (1024, 127, 9, 14, False),      # one before a tile edge, B = 16 (fold)
    (1024, 128, 8, 14, False),      # on the edge, B = 8 (tell)
    (1024, 129, 16, 14, True),      # one past it, B = 16, ARD
    (1024, 128, 512, 14, False),    # on the edge, B = 512
    (1024, 129, 1, 14, False),      # one past it, B = 1
    (1024, 255, 100, 14, False),    # one before the second edge, B = 128
    (1024, 257, 5, 14, False),      # one past it, B = 8
    (1024, 384, 512, 14, True),     # an odd count of active tiles (3), B = 512
    (64, 20, 32, 14, False),        # cap below one tile, B = 32 (fold)
    (64, 0, 64, 14, False),         # n = 0 and cap below one tile, B = 64
    (1024, 0, 512, 14, False),      # n = 0, B = 512: zero tiles only
    (1024, 0, 1, 14, False),        # n = 0, B = 1
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
    tail = w.clone()
    tail[n:] = float("nan")      # K1b reads only the rows < n of w
    assert torch.equal(gp_ops.gp_g(tail, lib, n), g)
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


def test_gp_append_wrappers_raise_on_what_the_forms_do_not_take(cuda):
    from repro_torch.kernels import gp_ops

    ls, xb, lb, lib, xnew = _gp_case(cuda, 64, 20, 3, 14, False, seed=5)
    xq = xnew[:3].contiguous()        # B = 3: neither a tell (1, 2, 4, 8) nor a fold (16k)
    with pytest.raises(ValueError, match="multiple of 16"):
        gp_ops.gp_w(lib, xb, xq, 20, 3, ls2=0.09, signal=1.0)
    with pytest.raises(ValueError, match="multiple of 16"):
        gp_ops.gp_g(torch.zeros((64, 3), dtype=torch.float64, device=cuda), lib, 20)
    odd = torch.zeros((40, 40), dtype=torch.float64, device=cuda)   # cap 40
    with pytest.raises(ValueError, match="capacity"):
        gp_ops.gp_g(torch.zeros((40, 4), dtype=torch.float64, device=cuda), odd, 20)
    flat = torch.zeros(64 * 64 + 1, dtype=torch.float64, device=cuda)
    shifted = flat[1:].view(64, 64)   # contiguous, 8 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        gp_ops.gp_w(shifted, xb, xnew, 20, 3, ls2=0.09, signal=1.0)
    with pytest.raises(ValueError, match="float64"):
        gp_ops.gp_g(torch.zeros((64, 4), dtype=torch.float32, device=cuda), lib, 20)


@pytest.mark.parametrize("cap,n,P,d,n_front,ard", [
    (64, 40, 512, 14, 1, False),        # S = 2
    (8192, 6250, 512, 14, 1, False),    # the search path, S = 2
    (8192, 6250, 512, 14, 100, True),   # S = 129, ARD
    (8192, 5000, 37, 5, 40, False),     # a pool that is not a warp multiple
])
def test_gp_ehvi_kernel_matches_plain(cuda, cap, n, P, d, n_front, ard):
    _check_ehvi(cuda, cap, n, P, d, n_front, ard, 0.09, seed=n + P + n_front)


# n = 0, 1, one below, on and one past the 64-row step edge that ends the
# last row split at the search path's P (8 tiles x 33 splits on 132 SMs),
# and the search path's n; P one candidate, and one below and one past a
# 64-candidate tile edge; d = 3, the search path's 14, and 33 (above the
# 48 KB of shared memory a block gets without opting in); S = 2 and 129
@pytest.mark.parametrize("n", [0, 1, 6143, 6144, 6145, 6250])
@pytest.mark.parametrize("P", [1, 511, 513])
@pytest.mark.parametrize("d", [3, 14, 33])
@pytest.mark.parametrize("n_front", [1, 100], ids=["S2", "S129"])
def test_gp_ehvi_kernel_across_split_edges(cuda, n, P, d, n_front):
    # ls² grows with d, so the kernel values stay far from 0 at d = 33
    _check_ehvi(cuda, 8192, n, P, d, n_front, False, 0.09 * d / 14, seed=n + P + d + n_front)


def _check_ehvi(dev, cap, n, P, d, n_front, ard, ls2_iso, seed):
    """K2 against its plain version within 1e-8 and bitwise across two
    launches, each counted once; some score is positive.  ``ls2_iso`` is
    ls² when isotropic (ARD pre-scales the rows, ls² = 1)."""
    from repro_torch.kernels import gp_ops

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=dev)

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
    ls2 = 1.0 if ard else ls2_iso
    args = (t(xb), t(alpha), n, t(rng.random((P, d))), t(stair), t(ymd), ils)
    before = gp_ops.gp_ehvi.launches
    got = gp_ops.gp_fused_ehvi(*args, ls2=ls2, signal=1.0)
    got2 = gp_ops.gp_fused_ehvi(*args, ls2=ls2, signal=1.0)
    torch.cuda.synchronize()
    assert gp_ops.gp_ehvi.launches == before + 2
    assert torch.equal(got, got2)
    xq = args[3] if ils is None else args[3] * ils
    xs = args[0] if ils is None else args[0] * ils
    want = gp_ops.gp_ehvi_plain(xq, xs, args[1], n, args[4], args[5], ls2=ls2, signal=1.0)
    assert got.shape == (P,) and got.is_contiguous()
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


@pytest.mark.parametrize("algo", ["bayesopt", "pal"])
@pytest.mark.parametrize("seed", [0, 7])
def test_snapshot_restore_bit_identical_picks_on_the_card(cuda, algo, seed):
    """``tests/test_durable.py``'s snapshot → restore at the paper's space
    (llama2-7b's generation space, d = 7) on the cuda tier: a fresh searcher
    restored from the pickled state continues with the original's picks,
    through the kernels, with 5-row folds padded to 8 so the live factor is
    wider than n rows would need; the snapshot holds no tensor."""
    import pickle

    from repro_torch.core import ALGORITHMS
    from repro_torch.kernels import gp_ops
    from repro_torch.launch.explore import generation_space

    space = generation_space(get_arch("llama2-7b"), 8)
    assert len(space.knobs) == 7

    def objective(c):
        x = space.encode(c)
        return np.array([1.0 + x[0] + 0.5 * x[3], 2.0 - x[1] + 0.3 * x[4]])

    def mk():
        return ALGORITHMS[algo](space, seed=seed, n_init=6, pool_size=128, gp_mode="cuda")

    a = mk()
    for size in (6, 5, 5, 5, 5, 5):
        for c in a.ask(size):
            a.tell(c, objective(c))
    asked = a.ask(5)                  # folds 26 -> 31 rows at capacity 64
    assert (a._gp._n, a._gp._cap) == (31, 64)
    blob = pickle.dumps(a.state_dict())
    assert b"torch" not in blob
    b = mk()
    b.load_state(pickle.loads(blob))
    assert (b._gp._n, b._gp._cap) == (31, 64)
    before = gp_ops.gp_w.launches
    for _ in range(4):
        for c in asked:
            a.tell(c, objective(c))
            b.tell(c, objective(c))
        asked = a.ask(5)
        assert b.ask(5) == asked
    assert gp_ops.gp_w.launches > before


# ---------------------------------------------------------------------------
# K4 (the SSD scan) and K5 (top-k gating) against their plain versions
# ---------------------------------------------------------------------------


def _ssd(dev, b, s, h, p, n, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=dev))
    a_log = -dt * torch.sigmoid(torch.randn((b, s, h), generator=g, device=dev))
    x = torch.randn((b, s, h, p), generator=g, device=dev).to(dtype)
    bb = (0.4 * torch.randn((b, s, n), generator=g, device=dev)).to(dtype)
    cc = (0.4 * torch.randn((b, s, n), generator=g, device=dev)).to(dtype)
    return x, a_log, bb, cc, dt


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", [
    (2, 64, 2, 16, 16, 16, torch.float32),        # tests/test_kernels.py's grid
    (2, 96, 4, 32, 32, 32, torch.float32),
    (2, 40, 1, 16, 64, 16, torch.float32),
    (4, 64, 48, 64, 128, 256, torch.bfloat16),    # mamba2-780m: the Engine's prefill
    (1, 17, 48, 64, 128, 256, torch.bfloat16),    # a slot prefill, chunk clamped to 32
    (1, 600, 48, 64, 128, 256, torch.bfloat16),   # 3 chunks, the last one ragged
    (1, 300, 128, 64, 16, 256, torch.bfloat16),   # jamba-like: H 128, N 16
    (2, 200, 4, 128, 64, 64, torch.float32),      # P 128, 64-row chunks
], ids=["grid0", "grid1", "grid2_pad", "engine", "slot17", "s600", "jamba", "p128"])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk, dtype):
    from repro_torch.kernels import ssd_scan as k4

    args = _ssd(cuda, b, s, h, p, n, dtype, seed=s + h)
    before = k4.ssd_scan.launches
    y, state = k4.ssd_scan(*args, chunk=chunk)
    y2, state2 = k4.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert k4.ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(state, state2)
    want_y, want_state = k4.ssd_scan_plain(*args, chunk=k4.clamp_chunk(chunk, s))
    assert y.dtype == dtype and state.dtype == torch.float32
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(state, want_state, atol=1e-4, rtol=1e-4)


def _check_ssd_bf16(args, chunk, fill=None):
    """K4's tensor-core path against the plain version and its mirror; two
    launches bitwise equal, one count a call.  bf16: y at 2e-2 and in fp32
    at one bf16 rounding, the state at 1e-4; fp32: y and the state at
    1e-4.  ``fill``: a value written over every SM's shared memory before
    each launch, which the kernel must not read."""
    from repro_torch.kernels import ssd_scan as k4

    q = k4.clamp_chunk(chunk, args[0].shape[1])
    outs = []
    for _ in range(2):
        if fill is not None:
            k4.fill_shared_memory(fill, args[0].device.index)
        before = k4.ssd_scan.launches
        outs.append(k4.ssd_scan(*args, chunk=chunk))
        assert k4.ssd_scan.launches == before + 1
    torch.cuda.synchronize()
    (y, state), (y2, state2) = outs
    assert torch.equal(y, y2) and torch.equal(state, state2)
    want_y, want_state = k4.ssd_scan_plain(*args, chunk=q)
    mirror_y, mirror_state = k4.ssd_scan_mirror(*args, chunk=q)
    tol = 2e-2 if y.dtype == torch.bfloat16 else 1e-4
    for wy, ws in ((want_y, want_state), (mirror_y, mirror_state)):
        torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(state, ws, atol=1e-4, rtol=1e-4)
    if y.dtype == torch.bfloat16:
        want32, _ = k4.ssd_scan_plain(*(t.float() for t in args), chunk=q)
        torch.testing.assert_close(y.float(), want32, atol=1e-4, rtol=2 ** -8)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 600, 48, 64, 128, 256),   # 3 chunks, the last ragged: three launches behind one call
    (6, 600, 5, 64, 128, 64),     # an odd H
    (1, 100, 4, 64, 128, 8),      # chunk 8: 13 chunks
] + [(1, 150, 3, p, n, 64) for p in (16, 32, 64, 128) for n in (16, 32, 64, 128)],
    ids=["s600_b2", "h5", "chunk8"]
        + [f"p{p}_n{n}" for p in (16, 32, 64, 128) for n in (16, 32, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ssd_tensor_core_path(cuda, b, s, h, p, n, chunk, dtype):
    """The tensor-core kernel against the plain version (bf16 also in fp32)
    and its mirror; bitwise repeat; one count a call."""
    _check_ssd_bf16(_ssd(cuda, b, s, h, p, n, dtype, seed=s + h + p + n), chunk)


@pytest.mark.parametrize("b,s,h,chunk", [
    (1, 17, 48, 256),    # chunk clamped to 32: one row tile, rows 17..31 past L
    (1, 33, 48, 256),    # chunk 64
    (1, 600, 48, 256),   # the last chunk holds 88 rows
    (1, 100, 4, 8),      # chunk 8: 16-row steps reach past the chunk
    (4, 600, 48, 75),    # an odd chunk: 8 chunks of 75 rows, two row tiles each
], ids=["s17", "s33", "s600", "chunk8", "chunk75"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ssd_reads_no_stale_shared_memory(cuda, b, s, h, chunk, dtype):
    """Every SM's shared memory is filled with NaN (then with inf) before
    each launch: the kernel reads only shared memory it wrote, so y and the
    state stay finite and pass the same gates."""
    args = _ssd(cuda, b, s, h, 64, 128, dtype, seed=s + chunk)
    for fill in (float("nan"), float("inf")):
        _check_ssd_bf16(args, chunk, fill=fill)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (4, 64, 48, 64, 128, 256), (1, 17, 48, 64, 128, 32), (1, 600, 48, 64, 128, 256),
    (6, 600, 5, 64, 128, 64), (1, 100, 4, 64, 128, 8), (4, 600, 8, 64, 128, 75),
    (2, 520, 6, 128, 32, 128),
])
def test_ssd_schedule_matches_the_kernel(cuda, b, s, h, p, n, chunk):
    """``ssd_scan.schedule`` and ``block_work`` (which the CPU tests check
    for cover) give the C library's grids and its decode of every block."""
    from repro_torch.kernels import ssd_scan as k4

    grids = k4.kernel_grids(b, s, h, p, n, chunk)
    assert grids == k4.schedule(b, s, h, p, n, chunk)["grids"]
    for launch, grid in enumerate([grids[0]] + grids[2:]):
        for blk in range(grid):
            assert (k4.kernel_block_work(b, s, h, p, n, chunk, launch, blk)
                    == k4.block_work(b, s, h, n, chunk, launch, blk)), (launch, blk)


def test_ssd_wrapper_raises_on_misaligned_bf16(cuda):
    from repro_torch.kernels import ssd_scan as k4

    x, a_log, bb, cc, dt = _ssd(cuda, 1, 16, 2, 16, 16, torch.bfloat16)
    shifted = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        k4.ssd_scan(shifted, a_log, bb, cc, dt)


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import ssd_scan as k4

    x, a_log, bb, cc, dt = _ssd(cuda, 1, 16, 2, 48, 16, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        k4.ssd_scan(x, a_log, bb, cc, dt)
    x, a_log, bb, cc, dt = _ssd(cuda, 1, 16, 2, 16, 16, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        k4.ssd_scan(x, a_log.double(), bb, cc, dt)
    with pytest.raises(ValueError, match="dtypes"):
        k4.ssd_scan(x, a_log, bb.bfloat16(), cc, dt)


@pytest.mark.parametrize("t,e,k,ties", [
    (256, 64, 6, False),    # deepseek-moe-16b at the Engine's prefill
    (256, 64, 6, True),     # rows with exact ties
    (1, 64, 6, False), (37, 64, 6, True), (1000, 16, 4, False),   # T off any block
    (33, 256, 8, False), (40, 4, 4, True), (9, 2, 2, True),
    (16, 72, 10, False), (16, 72, 10, True),          # granite-4.0-h: a decode step's rows
    (8192, 72, 10, False), (8192, 72, 10, True),      # and its longest prefill
    (5, 64, 32, True),                                # k at a warp's 32 lanes
])
def test_topk_kernel_matches_plain(cuda, t, e, k, ties):
    from repro_torch.kernels import topk_gating as k5

    g = torch.Generator(device=cuda).manual_seed(t + e + k)
    logits = torch.randn((t, e), generator=g, device=cuda)
    if ties:
        logits = torch.round(logits * 2) / 2
    before = k5.topk_gating.launches
    p, ids = k5.topk_gating(logits, k)
    p2, ids2 = k5.topk_gating(logits, k)
    torch.cuda.synchronize()
    assert k5.topk_gating.launches == before + 2
    assert torch.equal(p, p2) and torch.equal(ids, ids2)
    want_p, want_ids = k5.topk_gating_plain(logits, k)
    assert ids.dtype == torch.int32 and torch.equal(ids, want_ids)
    assert (p - want_p).abs().max().item() <= 1e-6


@pytest.mark.parametrize("ties", [False, True])
def test_topk_autograd_backward_matches_plain(cuda, ties):
    """K5 under autograd at the MoE trainer's shape (T 2048, E 64, k 6): one
    forward launch, the same ids, and dL/dlogits from its plain-PyTorch
    backward within 1e-6 of autograd through the plain version on the card."""
    from repro_torch.kernels import topk_gating as k5

    g = torch.Generator(device=cuda).manual_seed(11)
    logits = torch.randn((2048, 64), generator=g, device=cuda)
    if ties:
        logits = torch.round(logits * 2) / 2
    grad_p = torch.randn((2048, 6), generator=g, device=cuda)
    a = logits.clone().requires_grad_(True)
    before = k5.topk_gating.launches
    p, ids = k5.topk_gating(a, 6)
    (p * grad_p).sum().backward()
    torch.cuda.synchronize()
    assert k5.topk_gating.launches == before + 1 and p.grad_fn is not None
    b = logits.clone().requires_grad_(True)
    want_p, want_ids = k5.topk_gating_plain(b, 6)
    (want_p * grad_p).sum().backward()
    assert torch.equal(ids, want_ids)
    assert (a.grad - b.grad).abs().max().item() <= 1e-6


def test_raw_stream_accessor_is_the_current_stream(cuda):
    from repro_torch.kernels import build

    idx = torch.cuda.current_device()
    assert build.current_stream(idx) == torch.cuda.current_stream(idx).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert build.current_stream(idx) == side.cuda_stream
        assert build.current_stream(idx) == torch.cuda.current_stream(idx).cuda_stream
        assert side.cuda_stream != torch.cuda.default_stream(idx).cuda_stream


def test_topk_on_a_side_stream_runs_after_its_producer(cuda):
    """K5 launched while a side stream is current runs on that stream: it
    reads the logits a slow producer on the same stream writes, not the
    zeros they held before."""
    from repro_torch.kernels import topk_gating as k5

    g = torch.Generator(device=cuda).manual_seed(5)
    source = torch.randn((256, 64), generator=g, device=cuda)
    logits = torch.zeros_like(source)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    before = k5.topk_gating.launches
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)      # the producer starts late
        logits.copy_(source)
        p, ids = k5.topk_gating(logits, 6)
    side.synchronize()
    assert k5.topk_gating.launches == before + 1
    want_p, want_ids = k5.topk_gating_plain(source, 6)
    assert torch.equal(ids, want_ids)
    assert (p - want_p).abs().max().item() <= 1e-6


def test_topk_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import topk_gating as k5

    with pytest.raises(ValueError, match="E <= 256"):
        k5.topk_gating(torch.zeros((4, 300), device=cuda), 2)
    with pytest.raises(ValueError, match="k <="):
        k5.topk_gating(torch.zeros((4, 16), device=cuda), 17)
    with pytest.raises(ValueError, match="k <="):
        k5.topk_gating(torch.zeros((4, 64), device=cuda), 33)
    with pytest.raises(ValueError, match="float32"):
        k5.topk_gating(torch.zeros((4, 16), device=cuda, dtype=torch.float64), 2)


@pytest.mark.parametrize("name", ["mamba2-780m", "deepseek-moe-16b", "jamba-v0.1-52b"])
def test_new_families_run_through_the_kernels(cuda, name):
    """Reduced fp32 models on the card: K4 once per Mamba layer and K5 once
    per MoE layer of a prefill; logits within 5e-5 of the same weights on the
    plain SSD path and on the CPU."""
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import topk_gating as k5

    cfg = reduced(get_arch(name))
    flags = BuildFlags(dtype="float32", ssd_impl="cuda")
    model = Model(cfg, flags, device=cuda, seed=0)
    plain = Model(cfg, BuildFlags(dtype="float32", ssd_impl="jnp"), device=cuda, seed=None)
    plain.load_state_dict(model.state_dict())
    cpu = Model(cfg, flags, device="cpu", seed=None)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    specs = cfg.layer_specs()
    n_mamba = sum(s.mixer == "mamba" for s in specs)
    n_moe = sum(s.ffn == "moe" for s in specs)
    before = (k4.ssd_scan.launches, k5.topk_gating.launches)
    with torch.inference_mode():
        lk, _ = model.prefill({"tokens": toks})
    assert (k4.ssd_scan.launches - before[0], k5.topk_gating.launches - before[1]) == (
        n_mamba, n_moe)
    with torch.inference_mode():
        lp, _ = plain.prefill({"tokens": toks})
        lc, _ = cpu.prefill({"tokens": toks})
    torch.testing.assert_close(lk, lp, atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(lk.cpu(), lc, atol=5e-5, rtol=5e-5)


def test_mamba_slot_server_equals_engine_on_the_card(cuda):
    """Reduced fp32 mamba2-780m with K4 on the card: each request served by a
    SlotServer (3 requests over 2 slots) gives the tokens of a solo Engine."""
    from repro_torch.serve import Engine, SlotServer

    cfg = reduced(get_arch("mamba2-780m"))
    model = Model(cfg, BuildFlags(dtype="float32", ssd_impl="cuda"), device=cuda, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 19, 7)]
    new = [6, 4, 8]
    srv = SlotServer(model, n_slots=2, max_len=48)
    for i, (p, n) in enumerate(zip(prompts, new)):
        srv.submit(i, p, n)
    got = {r.rid: r.out for r in srv.run()}
    for i, (p, n) in enumerate(zip(prompts, new)):
        solo = Engine(model, max_len=48).generate({"tokens": p[None]}, n)
        assert got[i] == solo.tokens[0].tolist()


# ---------------------------------------------------------------------------
# K6: decode attention in place on the K/V cache
# ---------------------------------------------------------------------------

def _decode_case(dev, b, s_max, h, hkv, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g, device=dev).to(dtype)
    k_new, v_new = (torch.randn((b, 1, hkv, d), generator=g, device=dev).to(dtype)
                    for _ in range(2))
    caches = [torch.randn((b, s_max, hkv, d), generator=g, device=dev).to(dtype)
              for _ in range(2)]
    return q, k_new, v_new, caches


def _decode_positions(b, s_max, split_len, seed, window=0):
    """Rows at 0, S_max - 1, a split's last and first position, with a
    window one whose window starts on a split's first position, the rest
    spread over the cache."""
    edges = [0, s_max - 1, split_len - 1, split_len, min(2 * split_len, s_max - 1)]
    if window:
        edges.append(min(split_len + window - 1, s_max - 1))
    rest = np.random.default_rng(seed).integers(0, s_max, max(0, b - len(edges)))
    return [int(p) for p in (edges + rest.tolist())[:b]]


def _decode_reference(q, caches, pos, theta, window, rope=True, scale=None):
    """fp64 attention over the caches the plain version wrote, from the q it
    ropes (rounded to q's dtype, as K6 rounds it), or from q as it is with
    ``rope`` False, at softmax scale ``scale`` (None: d ** -0.5)."""
    from repro_torch.models.layers import apply_rope

    b, _, h, d = q.shape
    s_max, hkv = caches[0].shape[1], caches[0].shape[2]
    posb = torch.as_tensor(pos, device=q.device).reshape(-1, 1).expand(b, 1).long()
    qr = (apply_rope(q, posb, theta) if rope else q).double()
    k, v = caches[0].double(), caches[1].double()
    idx = torch.arange(s_max, device=q.device)[None, :]
    mask = idx <= posb
    if window:
        mask &= (posb - idx) < window
    rep = h // hkv
    lg = (torch.einsum("bkrd,bskd->bkrs", qr[:, 0].reshape(b, hkv, rep, d), k)
          * (d ** -0.5 if scale is None else scale))
    lg = torch.where(mask[:, None, None, :], lg, -torch.inf)
    o = torch.einsum("bkrs,bskd->bkrd", torch.softmax(lg, dim=-1), v)
    return o.reshape(b, 1, h, d)


@pytest.mark.parametrize("b,s_max,h,hkv,d,window,dtype", [
    (32, 2560, 16, 16, 128, 0, torch.bfloat16),    # dsmoe16b chat
    (24, 4096, 16, 16, 128, 0, torch.bfloat16),    # dsmoe16b longdoc
    (4, 1024, 32, 8, 128, 0, torch.bfloat16),      # GQA 32/8 (jamba, llama4's 40/8 alike)
    (4, 1024, 32, 8, 128, 0, torch.float32),
    (8, 2560, 32, 16, 128, 1024, torch.bfloat16),  # gemma3's local layers
    (4, 600, 32, 2, 128, 0, torch.bfloat16),       # GQA 16 (glm4-9b)
    (6, 700, 24, 24, 64, 0, torch.float32),        # musicgen-medium
    (6, 700, 32, 4, 64, 37, torch.bfloat16),       # tinyllama-1.1b, a short window
    (5, 200, 4, 2, 16, 0, torch.float32),          # the reduced models
    (5, 200, 4, 2, 16, 70, torch.bfloat16),
], ids=["chat", "longdoc", "gqa4-bf16", "gqa4-fp32", "window1024", "gqa16", "d64-fp32",
        "d64-gqa8", "d16-fp32", "d16-bf16"])
def test_decode_attention_matches_plain(cuda, b, s_max, h, hkv, d, window, dtype):
    """K6 against its plain version on the card: the caches bitwise equal
    after both (the new rows written alike, every other byte untouched), the
    output within the file's tolerance of the plain version's, and within
    one rounding to q's dtype of fp64 attention (K6 keeps the logits and
    probabilities in fp32)."""
    from repro_torch.kernels import decode_attention as k6

    q, k_new, v_new, caches = _decode_case(cuda, b, s_max, h, hkv, d, dtype, seed=b + d)
    _, split_len = k6.schedule(s_max, b * hkv)
    positions = _decode_positions(b, s_max, split_len, seed=d, window=window)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    theta = 10000.0
    kc = [c.clone() for c in caches]
    pc = [c.clone() for c in caches]
    before = k6.decode_attention.launches
    got = k6.decode_attention(q, k_new, v_new, *kc, pos, theta, window=window)
    assert k6.decode_attention.launches == before + 1
    want = decode_attention_plain(q, k_new, v_new, *pc, pos, theta, window=window)
    torch.cuda.synchronize()
    assert torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1])
    assert not torch.equal(kc[0], caches[0])
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    ref = _decode_reference(q, pc, pos, theta, window)
    err = (got.double() - ref).abs()
    bound = 1e-4 + (2 ** -8 if dtype == torch.bfloat16 else 2e-6) * ref.abs()
    assert (err <= bound).all(), err.max().item()


def test_decode_attention_repeats_bitwise(cuda):
    from repro_torch.kernels import decode_attention as k6

    q, k_new, v_new, caches = _decode_case(cuda, 32, 2560, 16, 16, 128, torch.bfloat16, seed=3)
    pos = torch.tensor(_decode_positions(32, 2560, 320, seed=3), dtype=torch.int32, device=cuda)
    outs = []
    for _ in range(2):
        kc = [c.clone() for c in caches]
        outs.append((k6.decode_attention(q, k_new, v_new, *kc, pos, 1e4), kc))
    (o1, c1), (o2, c2) = outs
    assert torch.equal(o1, o2) and torch.equal(c1[0], c2[0]) and torch.equal(c1[1], c2[1])


def test_decode_attention_rows_outside_the_cache(cuda):
    """A row whose position lies outside [0, S_max) writes nothing and gets
    zeros; the other rows are the plain version's."""
    from repro_torch.kernels import decode_attention as k6

    q, k_new, v_new, caches = _decode_case(cuda, 3, 700, 8, 2, 64, torch.bfloat16, seed=6)
    kc = [c.clone() for c in caches]
    pos = torch.tensor([-1, 700, 650], dtype=torch.int32, device=cuda)
    got = k6.decode_attention(q, k_new, v_new, *kc, pos, 1e4)
    assert torch.equal(got[:2], torch.zeros_like(got[:2]))
    assert torch.equal(kc[0][:2], caches[0][:2]) and torch.equal(kc[1][:2], caches[1][:2])
    pc = [c[2:].clone() for c in caches]
    want = decode_attention_plain(q[2:], k_new[2:], v_new[2:], *pc, pos[2:], 1e4)
    assert torch.equal(kc[0][2:], pc[0]) and torch.equal(kc[1][2:], pc[1])
    torch.testing.assert_close(got[2:].float(), want.float(), atol=2e-2, rtol=2e-2)


def test_decode_attention_makes_no_host_sync(cuda):
    """Neither a per-slot (B,) int32 position tensor nor an int64 one, which
    the wrapper casts, makes it read from the device or synchronise."""
    from repro_torch.kernels import decode_attention as k6

    q, k_new, v_new, caches = _decode_case(cuda, 8, 512, 32, 8, 128, torch.bfloat16, seed=4)
    pos = torch.arange(100, 108, dtype=torch.int32, device=cuda)
    pos64 = torch.full((8,), 200, dtype=torch.long, device=cuda)
    k6.decode_attention(q, k_new, v_new, *caches, pos, 1e4)      # builds, plans, frequencies
    k6.decode_attention(q, k_new, v_new, *caches, pos64, 1e4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            k6.decode_attention(q, k_new, v_new, *caches, pos, 1e4)
            k6.decode_attention(q, k_new, v_new, *caches, pos64, 1e4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_decode_attention_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import decode_attention as k6

    def call(b=2, s=64, h=4, hkv=2, d=64, dtype=torch.float32, window=0, **edit):
        q, k_new, v_new, caches = _decode_case(cuda, b, s, h, hkv, d, dtype)
        args = dict(q=q, k_new=k_new, v_new=v_new, cache_k=caches[0], cache_v=caches[1],
                    pos=torch.full((b,), 5, dtype=torch.int32, device=cuda))
        args.update({k: f(args[k]) for k, f in edit.items()})
        return k6.decode_attention(args["q"], args["k_new"], args["v_new"], args["cache_k"],
                                   args["cache_v"], args["pos"], 1e4, window=window)

    with pytest.raises(ValueError, match="tensor of positions"):
        call(pos=lambda t: 5)
    with pytest.raises(ValueError, match="head dim"):
        call(d=48)
    with pytest.raises(ValueError, match="GQA ratio"):
        call(h=64, hkv=2)
    with pytest.raises(ValueError, match="GQA ratio"):
        call(h=6, hkv=4)
    with pytest.raises(ValueError, match="dtypes"):
        call(dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        call(cache_v=lambda c: c.to(torch.bfloat16))
    with pytest.raises(ValueError, match="window"):
        call(window=-1)
    with pytest.raises(ValueError, match="do not match"):
        call(v_new=lambda t: t[:1])
    with pytest.raises(ValueError, match="contiguous"):
        call(q=lambda t: torch.cat([t, t], dim=-1)[..., :t.shape[-1]])
    with pytest.raises(ValueError, match="different devices"):
        call(cache_k=lambda c: c.cpu())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_server_through_k6_matches_the_plain_path(cuda, dtype, monkeypatch):
    """Reduced deepseek-moe-16b served by a SlotServer (5 requests over 3
    slots): one K6 call per attention layer of each decode step the host
    runs (the first, eagerly, and its capture; the graph's replays call no
    wrapper), and every decode step's logits within tolerance of the same
    server on K6's plain version (fp32 5e-5; bf16 2e-2 of max |logit|).
    The plain server runs ``decode_step_eager``, so that it takes no graph
    and calls the plain version at every attention layer of every step."""
    from repro_torch.kernels import decode_attention as k6
    from repro_torch.serve import SlotServer

    cfg = reduced(get_arch("deepseek-moe-16b"))
    model = Model(cfg, BuildFlags(dtype=dtype, attn_impl="flash"), device=cuda, seed=0)
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 19, 7, 30, 11)]

    def serve(step=None):
        logits = []
        step = step or model.decode_step

        def recording(tokens, caches, pos):
            out, caches = step(tokens, caches, pos)
            logits.append(out.float().cpu())
            return out, caches

        monkeypatch.setattr(model, "decode_step", recording)
        srv = SlotServer(model, n_slots=3, max_len=64)
        for i, p in enumerate(prompts):
            srv.submit(i, p, 6)
        srv.run()
        monkeypatch.undo()
        return logits

    before = k6.decode_attention.launches, _graph_counts(model)
    got = serve()
    captures, replays = (a - b for a, b in zip(_graph_counts(model), before[1]))
    assert (captures, replays) == (1, len(got) - 1)
    assert k6.decode_attention.launches - before[0] == n_attn * (len(got) - replays + captures)
    plain = _counted(decode_attention_plain)
    monkeypatch.setattr(k6, "decode_attention", plain)
    graphs = _graph_counts(model)
    want = serve(model.decode_step_eager)
    assert _graph_counts(model) == graphs
    assert plain.calls == n_attn * len(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if dtype == "float32":
            torch.testing.assert_close(g, w, atol=5e-5, rtol=5e-5)
        else:
            assert (g - w).abs().max().item() <= 2e-2 * w.abs().max().item()


def _counted(fn):
    """``fn`` with a count of its calls in ``.calls``."""
    def wrapper(*args, **kw):
        wrapper.calls += 1
        return fn(*args, **kw)

    wrapper.calls = 0
    return wrapper


# ---------------------------------------------------------------------------
# granite-4.0-h-small: K3 and K6 without rope at the softmax scale 1/128,
# and a reduced hybrid served through K3, K4, K5 (k = 10) and K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [2048, 8192])
def test_flash_attention_at_the_hybrids_scale(cuda, s):
    """K3 at granite's prefill shapes (32/8 heads of 128) and scale 1/128
    against the plain version at that scale, at the file's bf16 tolerance
    and within one bf16 rounding of the plain version in fp32; a scale of
    None is d ** -0.5, bitwise."""
    q, k, v = _qkv(cuda, 1, s, 32, 8, 128, torch.bfloat16, seed=s)
    got = fa.flash_attention(q, k, v, causal=True, scale=1 / 128)
    want = fa.flash_attention_plain(q, k, v, causal=True, scale=1 / 128)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    del want
    want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True,
                                      scale=1 / 128)
    torch.testing.assert_close(got.float(), want32, atol=1e-4, rtol=2 ** -8)
    del want32
    assert torch.equal(fa.flash_attention(q, k, v, causal=True),
                       fa.flash_attention(q, k, v, causal=True, scale=128 ** -0.5))


def test_decode_attention_without_rope_at_the_hybrids_scale(cuda):
    """K6 at granite's longdoc decode shape (16 rows of an 8224-position
    cache, 32/8 heads of 128), no rope and scale 1/128, positions from
    2048-8200 and at split edges: the caches bitwise the plain version's,
    the output at the file's tolerance of it and within one bf16 rounding
    of fp64 attention over q and k as they are."""
    from repro_torch.kernels import decode_attention as k6

    b, s_max, h, hkv, d = 16, 8224, 32, 8, 128
    q, k_new, v_new, caches = _decode_case(cuda, b, s_max, h, hkv, d, torch.bfloat16, seed=29)
    _, split_len = k6.schedule(s_max, b * hkv)
    edges = [split_len - 1, split_len, 2048, 8200, s_max - 1]
    positions = edges + np.random.default_rng(29).integers(2048, 8200, b - len(edges)).tolist()
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    kw = dict(rope=False, scale=1 / 128)
    kc, pc = [c.clone() for c in caches], [c.clone() for c in caches]
    got = k6.decode_attention(q, k_new, v_new, *kc, pos, 10000.0, **kw)
    want = decode_attention_plain(q, k_new, v_new, *pc, pos, 10000.0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1])
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    ref = _decode_reference(q, pc, pos, 10000.0, 0, **kw)
    err = (got.double() - ref).abs()
    assert (err <= 1e-4 + 2 ** -8 * ref.abs()).all(), err.max().item()


def test_decode_attention_plans_keep_rope_and_scale_apart(cuda):
    """Calls at one shape with rope on, then off, then at another scale each
    get their own plan: each output is the plain version's at its settings,
    and the three differ."""
    from repro_torch.kernels import decode_attention as k6

    q, k_new, v_new, caches = _decode_case(cuda, 4, 300, 32, 8, 128, torch.float32, seed=8)
    pos = torch.tensor([0, 77, 150, 299], dtype=torch.int32, device=cuda)
    outs = []
    for kw in (dict(), dict(rope=False), dict(rope=False, scale=1 / 128)):
        kc, pc = [c.clone() for c in caches], [c.clone() for c in caches]
        got = k6.decode_attention(q, k_new, v_new, *kc, pos, 10000.0, **kw)
        want = decode_attention_plain(q, k_new, v_new, *pc, pos, 10000.0, **kw)
        assert torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1])
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        outs.append(got)
    assert not torch.equal(outs[0], outs[1]) and not torch.equal(outs[1], outs[2])


def _granite_tiny():
    """A reduced granite-4.0-h: 10 layers, Mamba-2 and one NoPE GQA layer
    at scale 1/16, each followed by a top-10-of-16 MoE; the three multipliers."""
    from repro_torch.configs.base import ArchConfig, LayerSpec

    pattern = tuple([LayerSpec("mamba", "moe")] * 5 + [LayerSpec("attn", "moe")]
                    + [LayerSpec("mamba", "moe")] * 4)
    return ArchConfig(name="granite-tiny", family="hybrid", n_layers=10, d_model=64,
                      vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=16, n_experts=16,
                      n_shared_experts=2, moe_top_k=10, moe_d_ff=32, ssm_state=16,
                      ssm_head_dim=16, ssm_chunk=8, pattern=pattern, tie_embeddings=True,
                      norm_eps=1e-5, rope=False, attn_scale=1 / 16, embedding_multiplier=12.0,
                      residual_multiplier=0.22, logits_scaling=16.0)


def _graph_counts(model):
    return model.decode_graph_captures, model.decode_graph_replays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_slot_server_through_the_kernels(cuda, dtype, monkeypatch):
    """A reduced granite-4.0-h (10 layers: Mamba-2 and one NoPE GQA layer at
    scale 1/16, each followed by a top-10-of-16 MoE; the three multipliers)
    served by a SlotServer (5 requests over 3 slots): K3 once per attention
    layer of a prefill, K4 once per Mamba layer, K5 once per MoE layer of
    every model call the host runs, K6 once per attention layer of such a
    decode step (the first step and its capture; the graph's replays call
    no wrapper); every decode step's logits within tolerance of the same
    server on the CPU's plain paths with the same weights (fp32, 5e-5), or
    in bf16 of the same server with K6's plain version on
    ``decode_step_eager``, which takes no graph (2e-2 of max |logit|, as
    for deepseek-moe-16b above: a bf16 token may flip between the CPU's and
    the card's products, and the answers then part)."""
    from repro_torch.kernels import decode_attention as k6
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.serve import SlotServer

    cfg = _granite_tiny()
    flags = BuildFlags(dtype=dtype, attn_impl="flash", ssd_impl="cuda")
    model = Model(cfg, flags, device=cuda, seed=0)
    cpu = Model(cfg, flags, device="cpu", seed=None)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 40, 7, 30, 11)]

    def serve(m, step=None):
        logits = []
        step = step or m.decode_step

        def recording(tokens, caches, pos):
            out, caches = step(tokens, caches, pos)
            logits.append(out.float().cpu())
            return out, caches

        monkeypatch.setattr(m, "decode_step", recording)
        srv = SlotServer(m, n_slots=3, max_len=64)
        for i, p in enumerate(prompts):
            srv.submit(i, p, 6)
        srv.run()
        monkeypatch.undo()
        return logits

    before = (fa.flash_attention.launches, k4.ssd_scan.launches, k5.topk_gating.launches,
              k6.decode_attention.launches) + _graph_counts(model)
    got = serve(model)
    torch.cuda.synchronize()
    after = (fa.flash_attention.launches, k4.ssd_scan.launches, k5.topk_gating.launches,
             k6.decode_attention.launches) + _graph_counts(model)
    n = len(prompts)
    captures, replays = after[4] - before[4], after[5] - before[5]
    assert (captures, replays) == (1, len(got) - 1)
    hosted = len(got) - replays + captures          # decode calls that ran the wrappers
    assert [a - b for a, b in zip(after[:4], before[:4])] == [n, 9 * n, 10 * (n + hosted),
                                                             hosted]
    if dtype == "bfloat16":
        plain = _counted(decode_attention_plain)
        monkeypatch.setattr(k6, "decode_attention", plain)
        graphs = _graph_counts(model)
        want = serve(model, model.decode_step_eager)
        assert _graph_counts(model) == graphs
        assert plain.calls == len(want)             # one attention layer
    else:
        want = serve(cpu)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if dtype == "float32":
            torch.testing.assert_close(g, w, atol=5e-5, rtol=5e-5)
        else:
            assert (g - w).abs().max().item() <= 2e-2 * w.abs().max().item()


# ---------------------------------------------------------------------------
# The serving decode step as one captured CUDA graph (Model.decode_step)
# ---------------------------------------------------------------------------

def _served_model(cuda, name, dtype="bfloat16"):
    if name == "granite-tiny":
        cfg = _granite_tiny()
    else:
        cfg = reduced(get_arch(name))
    flags = BuildFlags(dtype=dtype, attn_impl="flash", ssd_impl="cuda")
    return cfg, Model(cfg, flags, device=cuda, seed=0)


def _serve_recorded(model, n_slots, prompts, new, step=None, max_len=64):
    """A SlotServer over ``prompts`` with ``step`` (default the model's
    ``decode_step``) as its decode: (each request's tokens, each decode
    step's tokens and logits copied at once, the server)."""
    from repro_torch.serve import SlotServer

    step = step or model.decode_step
    steps = []

    def recording(tokens, caches, pos):
        logits, caches = step(tokens, caches, pos)
        steps.append((tokens.clone(), logits.clone()))
        return logits, caches

    srv = SlotServer(model, n_slots=n_slots, max_len=max_len)
    for i, (p, n) in enumerate(zip(prompts, new)):
        srv.submit(i, p, n)
    model.decode_step = recording
    try:
        out = {r.rid: r.out for r in srv.run()}
    finally:
        del model.decode_step                       # back to the class's method
    torch.cuda.synchronize()
    return out, steps, srv


def _traffic(cfg, n, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, m).astype(np.int32)
               for m in rng.integers(3, 30, n)]
    return prompts, rng.integers(12, 30, n).tolist()


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-780m", "granite-tiny"])
def test_graphed_slot_server_equals_the_eager_path(cuda, name):
    """A bf16 SlotServer (12 requests over 3 slots, admissions between
    steps, at least 64 decode steps) on the captured decode step gives the
    tokens and every step's logits bitwise equal to the same traffic on
    ``decode_step_eager``; the first step runs eagerly and is captured (one
    capture), every later one is a replay, and the eager server takes no
    graph."""
    cfg, model = _served_model(cuda, name)
    prompts, new = _traffic(cfg, 12, seed=3)
    got, got_steps, _ = _serve_recorded(model, 3, prompts, new)
    assert _graph_counts(model) == (1, len(got_steps) - 1)
    assert len(got_steps) >= 64
    want, want_steps, _ = _serve_recorded(model, 3, prompts, new, step=model.decode_step_eager)
    assert _graph_counts(model) == (1, len(got_steps) - 1)
    assert got == want
    assert len(got_steps) == len(want_steps)
    for (gt, gl), (wt, wl) in zip(got_steps, want_steps):
        assert torch.equal(gt, wt)
        assert torch.equal(gl, wl), (gl.float() - wl.float()).abs().max().item()


def test_a_second_slot_server_captures_anew(cuda):
    """A second SlotServer on the same model (the first still alive, so its
    caches lie elsewhere) captures its own graph, and the model lets the
    first graph go; both servers' tokens equal the eager path's."""
    import weakref

    cfg, model = _served_model(cuda, "deepseek-moe-16b")
    prompts, new = _traffic(cfg, 5, seed=5)
    first, _, srv1 = _serve_recorded(model, 3, prompts, new)
    old, old_key = weakref.ref(model._decode_graph), model._decode_graph.key
    assert _graph_counts(model)[0] == 1
    second, _, srv2 = _serve_recorded(model, 3, prompts, new)
    assert _graph_counts(model)[0] == 2
    assert old() is None and model._decode_graph.key != old_key
    eager, _, _ = _serve_recorded(model, 3, prompts, new, step=model.decode_step_eager)
    assert first == second == eager
    del srv1, srv2


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-780m"])
def test_graphed_engine_equals_the_eager_path(cuda, name):
    """``Engine.generate`` (bf16, 4 prompts of 23 tokens, 20 new) passes a
    (B,) int32 position tensor on the model's device: the first call
    captures one graph at its first decode step and replays it at the
    other 18; the second captures anew, or, where its new caches land at
    the first's freed addresses (part of the graph's key), replays the
    first's graph at all 19.  Both calls' tokens are bitwise those of the
    same engine on ``decode_step_eager``, which takes no graph."""
    from repro_torch.serve import Engine

    cfg, model = _served_model(cuda, name)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 23)).astype(np.int32)}
    engine = Engine(model, max_len=48)
    positions = []

    def recording(tokens, caches, pos):
        positions.append((pos.dtype, pos.device, tuple(pos.shape)))
        return Model.decode_step(model, tokens, caches, pos)

    got, counts = [], []
    model.decode_step = recording
    try:
        for _ in range(2):
            before = _graph_counts(model)
            got.append(engine.generate(batch, 20).tokens)
            counts.append(tuple(a - b for a, b in zip(_graph_counts(model), before)))
    finally:
        del model.decode_step                       # back to the class's method
    assert set(positions) == {(torch.int32, model.device, (4,))} and len(positions) == 38
    assert counts[0] == (1, 18) and counts[1] in ((1, 18), (0, 19))
    graphs = _graph_counts(model)
    model.decode_step = model.decode_step_eager
    try:
        want = engine.generate(batch, 20).tokens
    finally:
        del model.decode_step
    assert _graph_counts(model) == graphs
    assert np.array_equal(got[0], want) and np.array_equal(got[1], want)


def test_an_int_position_on_the_card_goes_through_k6(cuda):
    """``Model.decode_step`` at an int position (bf16 reduced
    deepseek-moe-16b, 3 prompts of 9 tokens) runs eagerly on the card and
    its attention takes K6 at a (B,) tensor of that position, never the
    plain version: one launch per attention layer, and the logits and
    caches bitwise those of ``decode_step_eager`` at that tensor."""
    from repro_torch.kernels import decode_attention as k6
    from repro_torch.models import attention
    from repro_torch.serve.engine import pad_caches

    cfg, model = _served_model(cuda, "deepseek-moe-16b")
    n_attn = sum(s.mixer == "attn" for s in cfg.layer_specs())
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    with torch.no_grad():
        logits, caches = model.prefill({"tokens": toks})
        caches = pad_caches(caches, 9, 16)
        tok = torch.argmax(logits, dim=-1)[:, None]
        copies = [[{n: c.clone() for n, c in layer.items()} for layer in caches]
                  for _ in range(2)]
        plain = _counted(attention.decode_attention_plain)
        before, graphs = k6.decode_attention.launches, _graph_counts(model)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(attention, "decode_attention_plain", plain)
            got, _ = model.decode_step(tok, copies[0], 9)
        assert k6.decode_attention.launches == before + n_attn and plain.calls == 0
        assert _graph_counts(model) == graphs
        want, _ = model.decode_step_eager(
            tok, copies[1], torch.full((3,), 9, dtype=torch.int32, device=cuda))
    assert torch.equal(got, want)
    for a, b in zip(*copies):
        assert all(torch.equal(a[n], b[n]) for n in a)


def test_graphed_steps_count_the_eager_paths_routing(cuda):
    """With tracing on, the captured decode step records ``moe.assignments``
    and ``moe.dropped`` at every step, equal to the eager path's step by
    step, with one capture and a replay at every later step; one MoE
    layer's router is zeroed, so that every row picks the same experts and
    a decode step over 12 slots drops assignments."""
    from repro_torch import trace

    cfg, model = _served_model(cuda, "deepseek-moe-16b")
    moe_layer = next(layer for layer in model.stack.layers if layer.ffn_kind == "moe")
    with torch.no_grad():
        moe_layer.ffn.router.zero_()
    prompts, new = _traffic(cfg, 16, seed=9)

    def counted(step):
        trace.drain()
        trace.enable()
        graphs = _graph_counts(model)
        try:
            out, _, _ = _serve_recorded(model, 12, prompts, new, step=step)
        finally:
            trace.disable()
        spans, counters = trace.drain()
        names = ("moe.assignments", "moe.dropped")
        return (out, [(n, int(v)) for n, _, v in counters if n in names], spans,
                tuple(a - b for a, b in zip(_graph_counts(model), graphs)))

    got, got_counts, got_spans, got_graphs = counted(None)
    want, want_counts, _, want_graphs = counted(model.decode_step_eager)
    assert got == want
    assert got_counts == want_counts
    decode_steps = sum(1 for s in got_spans if s[0] == "model.decode_step")
    assert got_graphs == (1, decode_steps - 1) and want_graphs == (0, 0)
    assert sum(1 for s in got_spans if s[0] == "model.decode_replay") == decode_steps - 1
    # the run ends on a decode step over 12 rows, 4 over capacity on each of 2 experts
    assert got_counts[-1] == ("moe.dropped", 8)
