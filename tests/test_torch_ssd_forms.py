"""K4's bf16 tensor-core arithmetic and grid, on the CPU.

``ssd_scan_mirror`` repeats the CUDA kernel's pass order (chunk-local
states, the state pass, the incoming state's term) and its bf16 high/low
splits in plain PyTorch.  On the same bf16 inputs, made with numpy, it is
held against the plain version run in fp32 (``ssd_scan_plain``) and against
the JAX package's ``repro.kernels.ops.ssd_scan`` (the Pallas kernel in
interpret mode, as ``tests/test_torch_ssd.py`` runs it): y at one bf16
rounding (atol 1e-4, rtol 2**-8, ``chip_smoke.py``'s ``BF16_VS_FP32``), the
fp32 state at 1e-4.  The shapes are the serving path's five K4 calls with
H cut, ``chip_smoke.py``'s extra cases with H cut, chunks 8 to 256 with a
ragged last chunk, odd chunks, and odd head counts.

``schedule`` (the grid) is decoded by ``block_work`` as ``csrc/ssd_scan.cu``
decodes ``blockIdx`` (the card tests hold both against the C library), and
every (batch, chunk, row tile, head) must get exactly one y block and every
(batch, chunk, head, state columns) one state block.  The fp32 path (three
TF32 passes, whose arithmetic ``tests/test_torch_tf32_forms.py`` holds)
takes the same schedule, so these cases also cover its calls, among them
sharded_ssm's fp32 prefill at (4, 512).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import ssd_scan as k4

Y_TOL = dict(atol=1e-4, rtol=2 ** -8)    # one bf16 rounding of y
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
H100_SMS = 132


def _inputs(seed, b, s, h, p, n):
    """x, b, c as bf16 values; a_log, dt fp32; drawn as tests/test_kernels.py does."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (-dt / (1 + np.exp(-rng.standard_normal((b, s, h))))).astype(np.float32)
    bb = (0.4 * rng.standard_normal((b, s, n))).astype(np.float32)
    cc = (0.4 * rng.standard_normal((b, s, n))).astype(np.float32)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (x, bb, cc)]
    return bf[0], torch.from_numpy(a_log), bf[1], bf[2], torch.from_numpy(dt)


CASES = {
    # the serving path's K4 calls (mamba2-780m: P 64, N 128, chunk 256), H cut
    "engine_prefill": (4, 64, 8, 64, 128, 256),
    "slot_prefill_s64": (1, 64, 6, 64, 128, 256),
    "slot_prefill_s17": (1, 17, 6, 64, 128, 256),
    "slot_prefill_s600": (1, 600, 4, 64, 128, 256),
    "slot_prefill_s33": (1, 33, 6, 64, 128, 256),
    # chip_smoke.py's SSD_EXTRA_CASES, H cut, in bf16
    "grid_s64": (2, 64, 2, 16, 16, 16),
    "grid_s96": (2, 96, 4, 32, 32, 32),
    "grid_s40_pad": (2, 40, 1, 16, 64, 16),
    "jamba_like": (1, 300, 8, 64, 16, 256),
    "mamba_s600": (1, 600, 4, 64, 128, 256),
    "h5_odd_heads": (6, 600, 5, 64, 128, 64),
    "chunk8": (1, 100, 4, 64, 128, 8),
    "chunk75_odd": (2, 160, 3, 64, 128, 75),
    # chunks 8 to 256, each with a ragged last chunk
    "chunk8_ragged": (2, 45, 3, 16, 32, 8),
    "chunk16_ragged": (1, 100, 2, 32, 16, 16),
    "chunk64_ragged": (1, 130, 2, 16, 64, 64),
    "chunk128_ragged": (1, 300, 2, 128, 32, 128),
    "chunk256_ragged": (1, 520, 2, 16, 16, 256),
    # an odd H
    "h5": (1, 70, 5, 16, 32, 32),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mirror_matches_plain_and_pallas(name):
    b, s, h, p, n, chunk = CASES[name]
    args = _inputs(len(name) + s, b, s, h, p, n)
    q = k4.clamp_chunk(chunk, s)
    y, state = k4.ssd_scan_mirror(*args, chunk=q)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    f32 = [t.float() for t in args]
    want_y, want_state = k4.ssd_scan_plain(*f32, chunk=q)
    torch.testing.assert_close(y.float(), want_y, **Y_TOL)
    torch.testing.assert_close(state, want_state, **STATE_TOL)
    jy, jstate = ops.ssd_scan(*(jnp.asarray(t.numpy()) for t in f32), chunk=chunk)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy), **Y_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **STATE_TOL)


def test_mirror_takes_only_bf16():
    """The mirror repeats a kernel: bf16 (or, since the fp32 path is on the
    tensor cores too, fp32) for all of x, b and c, and nothing else."""
    x, a_log, b, c, dt = _inputs(0, 1, 16, 2, 16, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        k4.ssd_scan_mirror(x.float(), a_log, b, c, dt, chunk=16)
    with pytest.raises(ValueError, match="bfloat16"):
        k4.ssd_scan_mirror(x.half(), a_log, b.half(), c.half(), dt, chunk=16)


def _decode(bsz, s, h, n, chunk, plan):
    """Every chunk-kernel launch's work, block by block (``block_work``)."""
    launches = [plan["grids"][0]] + plan["grids"][2:]
    return [[w for blk in range(grid)
             if (w := k4.block_work(bsz, s, h, n, chunk, launch, blk)) is not None]
            for launch, grid in enumerate(launches)]


@pytest.mark.parametrize("bsz,s,h,p,n,chunk", [
    (4, 64, 48, 64, 128, 256),     # the serving path at full width
    (1, 64, 48, 64, 128, 256),
    (1, 17, 48, 64, 128, 256),
    (1, 600, 48, 64, 128, 256),
    (1, 33, 48, 64, 128, 256),
    (6, 600, 5, 64, 128, 64),      # an odd H
    (1, 100, 4, 64, 128, 8),       # chunk 8: 13 chunks
    (4, 600, 8, 64, 128, 75),      # an odd chunk: 8 chunks of two row tiles
    (2, 520, 6, 128, 32, 128),
    (4, 512, 48, 64, 128, 256),    # sharded_ssm's fp32 prefill: two full chunks
])
def test_schedule_covers_every_block_once(bsz, s, h, p, n, chunk):
    q = k4.clamp_chunk(chunk, s)
    plan = k4.schedule(bsz, s, h, p, n, q)
    launches = _decode(bsz, s, h, n, q, plan)
    nc = -(-s // q)
    assert plan["n_chunks"] == nc and len(plan["grids"]) == (1 if nc == 1 else 3)
    want_y = {("y", bi, c, hh, it) for bi in range(bsz) for c in range(nc)
              for it in range(-(-min(q, s - c * q) // k4.TILE)) for hh in range(h)}
    want_state = {("state", bi, c, hh, part) for bi in range(bsz) for c in range(nc)
                  for hh in range(h) for part in range(-(-n // k4.STATE_COLS))}
    work = [w for launch in launches for w in launch]
    assert len(work) == len(set(work))
    assert set(work) == want_y | want_state
    # the y blocks of a chunk after the first run after the state pass
    assert all(w[0] == "state" or w[2] == 0 for w in launches[0])
    assert all(w[0] == "y" and w[2] > 0 for launch in launches[1:] for w in launch)


@pytest.mark.parametrize("bsz,s", [(4, 64), (1, 64), (1, 17), (1, 33), (1, 600), (4, 512)])
def test_schedule_fills_an_h100_on_mamba2_widths(bsz, s):
    """Every serving-path call (and sharded_ssm's fp32 prefill) puts at
    least one block a SM in flight in its first launch: 48 heads × (row
    tiles + 2 state blocks) a sequence."""
    q = k4.clamp_chunk(256, s)
    plan = k4.schedule(bsz, s, 48, 64, 128, q)
    assert plan["grids"][0] >= H100_SMS
    assert plan["grids"][0] == bsz * 48 * (plan["row_tiles"] + plan["n_chunks"] * 2)
