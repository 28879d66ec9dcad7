"""The fp32 paths of K3 and K4 on the tensor cores: their TF32 arithmetic, on the CPU.

Both kernels split every fp32 operand x into hi = tf32(x) and
lo = tf32(x − hi) (``cvt.rna.tf32.f32``) and add three products,
hi·hi + hi·lo + lo·hi.  ``repro_torch.kernels.tf32`` repeats the rounding
with integer operations; here it is held against round-half-away-from-zero
computed in float64, and its split against its promises (TF32 values left
as they are, the low 13 mantissa bits of both parts zero, hi + lo within
2⁻²² of x).

The kernels' mirrors in plain PyTorch (``flash_attention_mirror_fp32``;
``ssd_scan_mirror`` on fp32 inputs) take the same numpy inputs as the plain
versions and as the JAX package (its oracle and its Pallas kernel in
interpret mode, as ``tests/test_torch_kernels.py`` and
``tests/test_torch_ssd_forms.py`` run them), across GQA, windows, ragged
sequence lengths, every head dim, and one-chunk and multi-chunk scans; each
stays within a quarter of its kernel's gate of the plain version: 5e-6 for
K3 (gate 2e-5), 2.5e-5 for K4 (gate 1e-4).  K3's mirror is as close to the
JAX package; K4's adds at most a quarter of its gate to the plain version's
own distance from the JAX package, whose fp32 sums run in another order.
One TF32 product instead of three misses K3's gate on a seeded d = 128
case: that is why the kernels take three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as k4
from repro_torch.kernels import tf32

K3_QUARTER = dict(atol=5e-6, rtol=5e-6)      # a quarter of K3's fp32 gate, 2e-5
K4_QUARTER = dict(atol=2.5e-5, rtol=2.5e-5)  # a quarter of K4's fp32 gate, 1e-4
K3_GATE = dict(atol=2e-5, rtol=2e-5)


def _low13(t):
    return t.view(torch.int32) & 0x1FFF


def _rna_reference(x):
    """TF32 rounding of fp32 values in float64: round half away from zero
    to 10 fractional mantissa bits (subnormals on the smallest exponent's
    grid)."""
    x64 = x.astype(np.float64)
    mag = np.abs(x64)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = np.exp2(np.maximum(e, -126) - 10)
    return np.sign(x64) * np.floor(mag / ulp + 0.5) * ulp


@pytest.mark.parametrize("scale", [1e-40, 1e-30, 1e-3, 1.0, 7.5e3, 1e30])
def test_round_tf32_is_cvt_rna(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 50))
    x = (rng.standard_normal(20_000) * scale).astype(np.float32)
    got = tf32.round_tf32(torch.from_numpy(x)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, _rna_reference(x))


def test_round_tf32_ties_go_away_from_zero_and_carry():
    one = np.float32(1.0).view(np.int32)
    bits = np.array([one + 0x1000, one + 0x0FFF, one + 0x3000,     # tie up, below, tie up
                     0x3FFFF000,                                     # all-ones mantissa: carries
                     0], dtype=np.int32)
    x = np.concatenate([bits, bits | np.int32(-2 ** 31)]).view(np.float32)
    got = tf32.round_tf32(torch.from_numpy(x)).numpy()
    want = np.array([1 + 2 ** -10, 1.0, 1 + 2 * 2 ** -10, 2.0, 0.0], dtype=np.float32)
    np.testing.assert_array_equal(got, np.concatenate([want, -want]))
    np.testing.assert_array_equal(got, _rna_reference(x).astype(np.float32))


def test_round_tf32_leaves_tf32_values_and_non_finite_ones():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32) * 100)
    once = tf32.round_tf32(x)
    assert torch.equal(tf32.round_tf32(once), once)
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0])
    got = tf32.round_tf32(special)
    assert torch.equal(got[:2], special[:2]) and torch.isnan(got[2])
    assert torch.equal(got[3:].view(torch.int32), special[3:].view(torch.int32))


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 1e3, 1e30])
def test_split_tf32_parts(scale):
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(50_000) * scale).astype(np.float32))
    hi, lo = tf32.split_tf32(x)
    assert int(_low13(hi).abs().max()) == 0 and int(_low13(lo).abs().max()) == 0
    rebuilt = hi.double() + lo.double()
    assert float(((rebuilt - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -22
    assert torch.equal(tf32.split_tf32(hi)[0], hi) and int(tf32.split_tf32(hi)[1].abs().max()) == 0


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _qkv(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


K3_CASES = {
    "d16_gqa": (2, 100, 4, 2, 16, 0),
    "d32_window": (2, 130, 4, 4, 32, 24),
    "d64_mqa_ragged": (1, 97, 6, 1, 64, 0),
    "d64_window": (1, 300, 4, 2, 64, 96),
    "d128": (1, 200, 4, 4, 128, 0),
    "d128_gqa_window": (2, 150, 4, 2, 128, 48),
    "d128_one_position": (1, 1, 2, 1, 128, 0),
    "serve_default_cut": (2, 16, 8, 1, 64, 0),      # launch.serve's defaults, heads cut
}


@pytest.mark.parametrize("name", list(K3_CASES))
def test_flash_mirror_matches_plain_and_reference(name):
    b, s, h, hkv, d, window = K3_CASES[name]
    arrs = _qkv(len(name) + s, b, s, h, hkv, d)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    got = fa.flash_attention_mirror_fp32(q, k, v, causal=True, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got, want, **K3_QUARTER)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)), **K3_QUARTER)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ops.flash_attention(jq, jk, jv, causal=True, window=window)), **K3_QUARTER)


def _flash_one_pass(q, k, v):
    """K3's function with each product one TF32 pass (causal, no window)."""
    d = q.shape[-1]
    r = tf32.round_tf32
    s = torch.einsum("bqhd,bshd->bhqs", r(q * d ** -0.5), r(k))
    n = q.shape[1]
    s = torch.where(torch.ones((n, n), dtype=torch.bool).tril(), s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqs,bshd->bqhd", r(p), r(v))
    return o / p.sum(dim=-1).transpose(1, 2)[..., None]


def test_one_tf32_pass_misses_the_fp32_gate():
    """One TF32 product keeps 11 significant bits: on a seeded d = 128 case it
    misses K3's 2e-5, where three passes stay within a quarter of it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, 1, 256, 4, 4, 128))
    want = fa.flash_attention_plain(q, k, v)
    one = _flash_one_pass(q, k, v)
    assert not torch.allclose(one, want, **K3_GATE)
    assert (one - want).abs().max().item() > 4 * 2e-5
    torch.testing.assert_close(fa.flash_attention_mirror_fp32(q, k, v), want, **K3_QUARTER)


def test_flash_mirror_takes_only_fp32():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention_mirror_fp32(q.bfloat16(), k.bfloat16(), v.bfloat16())


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, s, h, p, n):
    """fp32 x, a_log, b, c, dt, drawn as tests/test_kernels.py does."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (-dt / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)
    bb = (0.4 * rng.standard_normal((b, s, n))).astype(np.float32)
    cc = (0.4 * rng.standard_normal((b, s, n))).astype(np.float32)
    return [torch.from_numpy(t) for t in (x, a_log, bb, cc, dt)]


K4_CASES = {
    # mamba2-780m (P 64, N 128, chunk 256), H cut: serve_fp32's one-chunk
    # prefill and a 600-token prompt (3 chunks, the last ragged)
    "serve_prefill": (4, 64, 4, 64, 128, 256),
    "s600": (1, 600, 3, 64, 128, 256),
    # tests/test_kernels.py's fp32 grid
    "grid_s64": (2, 64, 2, 16, 16, 16),
    "grid_s96": (2, 96, 4, 32, 32, 32),
    "grid_s40_pad": (2, 40, 1, 16, 64, 16),
    # small and odd chunks, an odd H, P 128
    "chunk8": (1, 100, 4, 64, 128, 8),
    "chunk75_odd": (2, 160, 3, 64, 128, 75),
    "h5_p128": (1, 130, 5, 128, 32, 64),
}


@pytest.mark.parametrize("name", list(K4_CASES))
def test_ssd_fp32_mirror_matches_plain_and_pallas(name):
    b, s, h, p, n, chunk = K4_CASES[name]
    args = _ssd_inputs(len(name) + s, b, s, h, p, n)
    q = k4.clamp_chunk(chunk, s)
    y, state = k4.ssd_scan_mirror(*args, chunk=q)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    want_y, want_state = k4.ssd_scan_plain(*args, chunk=q)
    torch.testing.assert_close(y, want_y, **K4_QUARTER)
    torch.testing.assert_close(state, want_state, **K4_QUARTER)
    # The reference's fp32 sums run in another order: at 600 tokens it sits
    # up to 1.3e-4 (3.3e-5 relative) from the plain version itself.  The
    # mirror may add at most a quarter of the gate to that distance.
    jy, jstate = ops.ssd_scan(*(jnp.asarray(t.numpy()) for t in args), chunk=chunk)
    for got, plain, want in ((y, want_y, jy), (state, want_state, jstate)):
        want = np.asarray(want, np.float64)
        plain_gap = np.abs(plain.numpy() - want)
        room = plain_gap + K4_QUARTER["atol"] + K4_QUARTER["rtol"] * np.abs(want)
        assert (np.abs(got.numpy() - want) <= room).all()
