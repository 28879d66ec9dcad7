"""The host side of K1a/K1b's two CUDA forms, on the CPU.

``repro_torch.kernels.gp_ops`` picks a form by the padded block height B
(a tell at B ≤ 8, a fold of DMMA tiles at multiples of 16) and writes out
the fold's stream-K split of the triangle's contraction steps over the
SMs, which the host reports (``tiles``) and the device repeats.  These
tests hold the split to the triangle it must cover: every active output
tile and every active contraction tile exactly once, nothing above the
diagonal or past n, equal shares, and tiles cut only at a block's ends.  The kernels themselves run only
on the card (``tests/test_torch_cuda_kernels.py``).
"""
import numpy as np
import pytest

from repro_torch.kernels import gp_ops

TILE = gp_ops.FOLD_TILE

# (cap, n): tile edges (one before, on, one past), an odd count of active
# tiles, n = 0, cap below one tile, and the search path's state
SHAPES = [(64, 0), (64, 17), (64, 48), (1024, 0), (1024, 127), (1024, 128), (1024, 129),
          (1024, 255), (1024, 384), (1024, 1024), (8192, 6250)]


@pytest.mark.parametrize("B,want", [(1, "tell"), (2, "tell"), (4, "tell"), (8, "tell"),
                                    (16, "fold"), (64, "fold"), (512, "fold"), (48, "fold")])
def test_form_switches_between_eight_and_sixteen(B, want):
    assert gp_ops.form(B) == want


@pytest.mark.parametrize("B", [0, 3, 12, 24, 513])
def test_form_raises_on_blocks_neither_form_takes(B):
    with pytest.raises(ValueError, match="multiple of 16"):
        gp_ops.form(B)


def _active_tiles(n, cap, step):
    """(row tile, column tile) pairs of the lower triangle of a cap × cap
    L⁻¹ that hold an entry with row and column < n, in step × step tiles."""
    tiles = -(-cap // step)
    i = np.arange(tiles)[:, None]
    j = np.arange(tiles)[None, :]
    live = (j <= i) & (i * step < n) & (j * step < n)
    return {(int(a), int(b)) for a, b in zip(*np.nonzero(live))}


@pytest.mark.parametrize("cap,n", SHAPES)
@pytest.mark.parametrize("name", ["gp_w", "gp_g"])
@pytest.mark.parametrize("B", [16, 512])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_fold_split_walks_the_active_triangle_once(cap, n, name, B, sms):
    """Every contraction step of every active (triangle tile, width tile)
    lies in exactly one block's share, and together the steps of triangle
    tile t cover exactly the active lower tiles of its row (K1a) or column
    (K1b) of L⁻¹."""
    split = gp_ops.fold_split(name, n, B, sms)
    Y = -(-B // TILE)
    steps = [(t, y, k) for blk in split for t, y, lo, hi in blk for k in range(lo, hi)]
    assert len(steps) == len(set(steps))
    T = -(-n // TILE)
    want = {(t, y, k) for t in range(T) for y in range(Y)
            for k in range(gp_ops.fold_steps(name, t, n))}
    assert set(steps) == want
    visits = set()
    for t, y, k in steps:
        first = 0 if name == "gp_w" else t * TILE
        s = (first + k * gp_ops.FOLD_STEP) // TILE
        visits.add((t, s) if name == "gp_w" else (s, t))
    assert visits == _active_tiles(n, cap, TILE)


@pytest.mark.parametrize("n,B", [(6250, 512), (129, 16), (1024, 64), (6250, 16)])
@pytest.mark.parametrize("sms", [7, 132])
def test_fold_split_gives_equal_shares_cut_only_at_the_ends(n, B, sms):
    """Block shares differ by at most one step, each block's segments run
    in order, and only a block's first and last tile may be cut: the two
    parts a block may leave for the fix-up."""
    split = gp_ops.fold_split("gp_w", n, B, sms)
    sizes = [sum(hi - lo for *_, lo, hi in blk) for blk in split]
    assert len(split) == min(sms, sum(sizes)) and max(sizes) - min(sizes) <= 1
    for blk in split:
        assert [seg[:2] for seg in blk] == sorted(seg[:2] for seg in blk)
        for t, y, lo, hi in blk[1:-1]:
            assert (lo, hi) == (0, gp_ops.fold_steps("gp_w", t, n))
