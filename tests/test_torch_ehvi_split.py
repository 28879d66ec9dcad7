"""K2's grid on the CPU: the row splits of ``gp_ops.ehvi_split``, and the
fused EHVI at the row counts where the splits are cut, against the JAX
package.

K2's first pass runs a grid of 64-candidate tiles × row splits; each split
is a run of whole 64-row steps, and the device cuts the runs from (n, G)
as ``ehvi_split`` does.  These tests hold the runs to the rows they must
cover (every row < n exactly once, in order, none empty) and the grid to
the card it must fill (two blocks per SM at the search shape), and hold
``gp_fused_ehvi`` (its plain version on the CPU) to the reference's Pallas
kernel in interpret mode at the edge row counts.  The kernel itself runs
only on the card (``tests/test_torch_cuda_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gp_ops as ref_ops
from repro_torch.kernels import gp_ops

STEP = gp_ops.EHVI_STEP

# n = 0, 1, one below, on and one past a step edge (where runs are cut),
# near the first edges and the search path's, and the search path's n
EDGE_N = [0, 1, STEP - 1, STEP, STEP + 1, 2 * STEP - 1, 2 * STEP, 2 * STEP + 1,
          96 * STEP - 1, 96 * STEP, 96 * STEP + 1, 6250]


@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("P", [1, 511, 512, 513])
@pytest.mark.parametrize("sms", [1, 132])
def test_ehvi_split_covers_every_row_once_in_order(n, P, sms):
    tiles, runs = gp_ops.ehvi_split(n, P, sms)
    assert tiles == -(-P // gp_ops.EHVI_TILE)
    rows = [r for lo, hi in runs for r in range(lo, hi)]
    assert rows == list(range(n))
    assert all(lo % STEP == 0 for lo, _ in runs)         # whole steps
    if n:
        assert all(hi > lo for lo, hi in runs)          # no empty run
    else:
        assert runs == [(0, 0)]
    assert len(runs) <= max(1, -(-n // STEP))


@pytest.mark.parametrize("sms", [1, 7, 66, 132])
def test_ehvi_split_fills_the_card_at_the_search_shape(sms):
    """At P = 512, n = 6250 the grid holds at least two blocks per SM,
    and the runs differ by at most one step."""
    tiles, runs = gp_ops.ehvi_split(6250, 512, sms)
    assert tiles * len(runs) >= gp_ops.EHVI_BLOCKS_PER_SM * sms
    steps = [-(-(hi - lo) // STEP) for lo, hi in runs]
    assert max(steps) - min(steps) <= 1


def _t(a):
    return torch.as_tensor(np.asarray(a, float), dtype=torch.float64)


@pytest.mark.parametrize("n", [0, 1, STEP - 1, STEP, STEP + 1])
def test_fused_ehvi_matches_pallas_interpret_at_split_edges(n):
    cap, P, d = 2 * STEP, 8, 5
    rng = np.random.default_rng(n)
    xb = np.zeros((cap, d))
    xb[:n] = rng.random((n, d))
    alpha = np.zeros((cap, 2))
    alpha[:n] = rng.standard_normal((n, 2))
    xq = rng.random((P, d))
    front = np.sort(rng.random(5))
    x = np.concatenate([front, np.full(3, 1.2)])
    y = np.concatenate([1.0 - front, np.full(3, 1.0 - front[-1])])
    ref = np.array([1.2, 1.1])
    stair = np.stack([np.concatenate([[-np.inf], x]), np.concatenate([x, ref[:1]]),
                      np.concatenate([ref[1:], y])])
    ymd = np.array([[0.2, 0.3], [0.2, 0.3]])
    with jax.enable_x64(True):
        want = np.asarray(ref_ops.gp_fused_ehvi(
            jnp.asarray(xb), jnp.asarray(alpha), np.int32(n), jnp.asarray(xq),
            jnp.asarray(stair), jnp.asarray(ymd), None, ls2=0.1, signal=1.0, block=16,
            pool_block=8, interpret=True))
    got = gp_ops.gp_fused_ehvi(_t(xb), _t(alpha), n, _t(xq), _t(stair), _t(ymd), None,
                               ls2=0.1, signal=1.0)
    assert got.dtype == torch.float64 and got.shape == (P,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)
    assert np.any(want > 0)
