"""K1a, K1b, K2: the incremental GP's tell and ask kernels (``gp_mode="cuda"``).

Replaces the Pallas TPU kernels of ``repro/kernels/gp_ops.py``:

* **K1a** ``gp_w`` (``_w_kernel``): w = L⁻¹·K₁₂ over the active lower
  tiles, with the RBF block K₁₂ built once per call from the X rows;
* **K1b** ``gp_g`` (``_g_kernel``): g = wᵀ·L⁻¹ over the active lower tiles;
* **K2** ``gp_ehvi`` (``_ehvi_kernel``): per pool candidate, the posterior
  means of 2 objectives, denormalised, then the EHVI staircase sum, without
  materialising the (P, n) cross-kernel matrix.

``gp_append`` and ``gp_fused_ehvi`` are the reference's two entry points.
Between K1a and K1b the dense B×B Schur block and the slab writes of the
new rows stay ``torch.linalg``/indexing, as the reference leaves them to XLA.

The CUDA kernels are ``csrc/gp_ops.cu`` (built by ``kernels.build`` with nvcc
for ``sm_90a`` and called through ``ctypes``); that file's header says what
bounds each on an H100 and what its design does about it.  K1a and K1b have
two forms, picked by the padded block height B (``form``): a fold (B a
multiple of 16, 512 on the search path) runs DMMA tiles of 128 × 128 on
the float64 tensor cores, the triangle's contraction steps split in equal
shares over one block per SM (``fold_split``), and a tile cut between
blocks summed from their parts in block order; a tell (B ≤ 8, 1 on the search path)
reads the active triangle about once, one warp per row pair for K1a and
per-panel partial column sums for K1b.  ``tiles`` reports each form's
tiles and grids.  Every
wrapper takes its plain PyTorch version for CPU tensors only and, for a
CUDA tensor, launches its kernels or raises; it counts one launch per call
(``gp_w.launches``, ``gp_g.launches``, ``gp_ehvi.launches``) however many
kernels the call runs, and checks the shared memory it needs against the
device's limit once per (device, kernel, d).

K2 is two passes: a grid of 64-candidate tiles × row splits
(``ehvi_splits``: enough splits for two blocks per SM), whose blocks
contract candidates against staged rows on the float64 tensor cores, writes
each split's partial means to a workspace, and a warp per candidate adds
the splits in a fixed order and sweeps the staircase.

All of it is float64.  The kernels' tiles are their own: the reference's
``block``/``pool_block`` of 256 × 256 float64 (512 KB) do not fit a Hopper
block's 227 KB of shared memory.  ARD
lengthscales are handled by the caller pre-scaling X by ``ils`` with
``ls2 = 1``, as the reference does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

F64 = torch.float64


def tile_kern(a, b, ls2, signal):
    """RBF via ‖a‖² + ‖b‖² − 2a·b, clamped at 0, over ls² — the reference
    ``_tile_kern``'s GEMM form."""
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]) - 2.0 * (a @ b.T)
    return signal * torch.exp(-0.5 * d2.clamp_min(0.0) / ls2)


# ---------------------------------------------------------------------------
# plain versions: the oracle on the card, and what a CPU tensor runs
# ---------------------------------------------------------------------------


def gp_w_plain(lib, xs, xq, n, m, *, ls2, signal):
    """K1a's function: ``lib @ K₁₂`` with K₁₂ = RBF(xs, xq) masked to rows < n
    and columns < m.  lib (cap, cap), xs (cap, d), xq (B, d) -> w (cap, B)."""
    rows = torch.arange(lib.shape[0], device=lib.device) < n
    cols = torch.arange(xq.shape[0], device=lib.device) < m
    k12 = tile_kern(xs, xq, ls2, signal) * (rows[:, None] & cols[None, :]).to(F64)
    return lib @ k12


def gp_g_plain(w, lib, n):
    """K1b's function: ``wᵀ @ lib`` over rows < n.  w (cap, B) -> g (B, cap)."""
    return w[:n].T @ lib[:n]


def gp_ehvi_plain(xq, xs, alpha, n, stair, ymd, *, ls2, signal):
    """K2's function: the masked cross-kernel, the posterior means of 2
    objectives denormalised by ``ymd`` (rows mean, std), then the staircase
    sum over ``stair``'s (lows, ups, levels) rows.  -> (P,)"""
    cols = (torch.arange(xs.shape[0], device=xs.device) < n).to(F64)
    mu = (tile_kern(xq, xs, ls2, signal) * cols[None, :]) @ alpha
    mu = mu * ymd[1:2, :] + ymd[0:1, :]
    lows, ups, levels = stair[0:1, :], stair[1:2, :], stair[2:3, :]
    width = (ups - torch.maximum(lows, mu[:, 0:1])).clamp_min(0.0)
    height = (levels - mu[:, 1:2]).clamp_min(0.0)
    return (width * height).sum(1)


# ---------------------------------------------------------------------------
# the CUDA kernels' forms and schedules (pure Python: the CPU tests read them)
# ---------------------------------------------------------------------------

FOLD_TILE = 128            # fold output tiles are FOLD_TILE x FOLD_TILE
FOLD_STEP = 32             # contraction rows per fold step
TELL_BLOCKS = (1, 2, 4, 8)  # block heights B the tell form takes
TELL_PANEL = 64            # K1b tell: rows per partial sum
TELL_COLS = 512            # K1b tell: columns per block


EHVI_TILE = 64             # K2: candidates per block of the first pass
EHVI_STEP = 64             # K2: training rows staged per step
EHVI_BLOCKS_PER_SM = 2     # K2: the split aims at this many blocks per SM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def form(B: int) -> str:
    """The form of K1a/K1b a CUDA launch takes at padded block height B:
    ``"tell"`` for B in 1, 2, 4, 8 (bandwidth-bound), ``"fold"`` for a
    multiple of 16 (DMMA tiles).  ``gp_append``'s blocks are powers of two."""
    if B in TELL_BLOCKS:
        return "tell"
    if B > 0 and B % 16 == 0:
        return "fold"
    raise ValueError(f"the GP kernels take B in {TELL_BLOCKS} or a multiple of 16, "
                     f"got B={B}")


def fold_steps(name: str, t: int, n: int) -> int:
    """Contraction steps of triangle tile t in a fold: K1a's row tile walks
    rows k < min(n, its end), K1b's column tile rows i from its start to n."""
    if name == "gp_w":
        return _cdiv(min(n, FOLD_TILE * (t + 1)), FOLD_STEP)
    return _cdiv(n - FOLD_TILE * t, FOLD_STEP)


def fold_split(name: str, n: int, B: int, blocks: int) -> list:
    """The fold's stream-K split as the device makes it.  The tiles (t, y),
    t over the ceil(n / FOLD_TILE) active triangle tiles and y over the
    ceil(B / FOLD_TILE) width tiles, lie in that order, each of
    ``fold_steps(t)`` steps; block g of G = min(blocks, all steps) takes
    iterations [g·I // G, (g + 1)·I // G).  Returns each block's segments
    (t, y, first step, end step); a tile cut between blocks is summed from
    their parts, in block order, by the fix-up kernel."""
    T, Y = _cdiv(n, FOLD_TILE), _cdiv(B, FOLD_TILE)
    tiles = [(t, y, fold_steps(name, t, n)) for t in range(T) for y in range(Y)]
    iters = sum(steps for *_, steps in tiles)
    G = min(blocks, iters)
    begin = [g * iters // G for g in range(G)] + [iters]
    out = [[] for _ in range(G)]
    pu = 0
    for t, y, steps in tiles:
        for g in range(G):
            lo, hi = max(begin[g], pu), min(begin[g + 1], pu + steps)
            if lo < hi:
                out[g].append((t, y, lo - pu, hi - pu))
        pu += steps
    return out


def ehvi_splits(n: int, P: int, sms: int) -> int:
    """G, the row splits of K2's grid at n active rows and P candidates on
    ``sms`` SMs: max(1, min(steps, ceil(EHVI_BLOCKS_PER_SM · sms / tiles)))
    for ceil(n / EHVI_STEP) steps of rows and ceil(P / EHVI_TILE) tiles, so
    the tiles × G blocks fill the card at the search shape."""
    return max(1, min(_cdiv(n, EHVI_STEP), _cdiv(EHVI_BLOCKS_PER_SM * sms, _cdiv(P, EHVI_TILE))))


def ehvi_split(n: int, P: int, sms: int) -> tuple:
    """K2's grid: (candidate tiles, row runs).  The steps of rows are cut
    into ``ehvi_splits`` equal runs of whole steps, none empty; run g is
    rows [lo, hi) with hi ≤ n.  The device cuts the same runs from (n, G)."""
    tiles, steps, G = _cdiv(P, EHVI_TILE), _cdiv(n, EHVI_STEP), ehvi_splits(n, P, sms)
    edges = [min(n, g * steps // G * EHVI_STEP) for g in range(G + 1)]
    return tiles, list(zip(edges[:-1], edges[1:]))


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_CONFIG_KEYS = ("fold_tile_rows", "fold_tile_cols", "k_step", "fold_threads", "stages",
                "fold_smem_bytes", "fixup_rows", "tell_max_B", "tell_threads",
                "tell_panel_rows", "tell_panel_cols", "ehvi_tile", "ehvi_step",
                "ehvi_blocks_per_sm")
_KERNEL_IDS = {"gp_w": 0, "gp_g": 1, "gp_ehvi": 2}
_FITS = set()       # (device, kernel, d, fold) whose shared memory was checked
_SMS = {}           # device index -> streaming multiprocessors


def _lib() -> ctypes.CDLL:
    lib = build.load("gp_ops")
    if not getattr(lib, "_typed", False):
        p, i, f, ln = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_long
        lib.gp_workspace.argtypes = [i] * 5
        lib.gp_workspace.restype = ln
        lib.gp_w.argtypes = [p] * 5 + [ln] + [i] * 5 + [f, f, i, p]
        lib.gp_g.argtypes = [p] * 4 + [ln] + [i] * 4 + [p]
        lib.gp_ehvi.argtypes = [p] * 7 + [ln] + [i] * 5 + [f, f, i, p]
        for fn in (lib.gp_w, lib.gp_g, lib.gp_ehvi):
            fn.restype = i
        lib.gp_config.argtypes = [p]
        lib.gp_config.restype = None
        lib.gp_smem_bytes.argtypes = [i, i]
        lib.gp_smem_bytes.restype = i
        lib.gp_smem_limit.argtypes = [i]
        lib.gp_smem_limit.restype = i
        lib.gp_error_string.argtypes = [i]
        lib.gp_error_string.restype = ctypes.c_char_p
        out = (ctypes.c_int * len(_CONFIG_KEYS))()
        lib.gp_config(out)
        lib.config = dict(zip(_CONFIG_KEYS, out))
        want = {"fold_tile_rows": FOLD_TILE, "fold_tile_cols": FOLD_TILE, "k_step": FOLD_STEP,
                "tell_max_B": TELL_BLOCKS[-1], "tell_panel_rows": TELL_PANEL,
                "tell_panel_cols": TELL_COLS, "ehvi_tile": EHVI_TILE,
                "ehvi_step": EHVI_STEP, "ehvi_blocks_per_sm": EHVI_BLOCKS_PER_SM}
        if any(lib.config[k] != v for k, v in want.items()):
            raise RuntimeError(f"gp_ops.cu's shapes {lib.config} differ from gp_ops.py's {want}")
        lib._typed = True
    return lib


def tiles(B: int, cap: int, n: int) -> dict:
    """K1a's and K1b's form at block height B, their tiles, threads and
    shared memory, and the grids they launch at (cap, n) on the current
    device."""
    cfg = _lib().config
    out = {"form": form(B)}
    if out["form"] == "fold":
        split = {k: fold_split(k, n, B, sm_count(torch.cuda.current_device()))
                 for k in ("gp_w", "gp_g")}
        out.update(tile=[cfg["fold_tile_rows"], cfg["fold_tile_cols"]], k_step=cfg["k_step"],
                   threads=cfg["fold_threads"], stages=cfg["stages"],
                   smem_bytes=cfg["fold_smem_bytes"],
                   blocks={k: len(v) for k, v in split.items()},
                   split_tiles={k: len({seg[:2] for blk in v for seg in blk
                                        if seg[2] > 0 or seg[3] < fold_steps(k, seg[0], n)})
                                for k, v in split.items()},
                   fixup_grid=[_cdiv(cap, FOLD_TILE), _cdiv(B, FOLD_TILE),
                               FOLD_TILE // cfg["fixup_rows"]])
    else:
        warps = cfg["tell_threads"] // 32
        out.update(threads=cfg["tell_threads"], smem_bytes=0,
                   grid_w=[max(1, _cdiv((n + 1) // 2, warps), _cdiv((cap - n) * B, 4 * cfg["tell_threads"]))],
                   grid_g_partials=[_cdiv(n, TELL_COLS), _cdiv(n, TELL_PANEL)],
                   grid_g_sum=[_cdiv(B * cap, cfg["tell_threads"])],
                   panel=[TELL_PANEL, TELL_COLS])
    out["k12_grid"] = [_cdiv(n, FOLD_TILE) * FOLD_TILE // 64, _cdiv(B, min(B, 64))]
    return out


def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device ``device``, read once."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def _on_cpu(name, *ts) -> bool:
    """True for CPU tensors (plain version); checks what a launch needs."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: inputs lie on different devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in ts:
        if t.dtype != F64 or not t.is_contiguous():
            raise ValueError(f"{name} wants contiguous float64 tensors, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} wants tensors on 16-byte boundaries (cp.async)")
    return False


def smem_bytes(name: str, d: int, fold: bool = False) -> int:
    """The most dynamic shared memory a block of kernel ``name``'s launches
    needs at width d (at a fold, its DMMA tiles' too)."""
    lib = _lib()
    return max(lib.gp_smem_bytes(_KERNEL_IDS[name], d),
               lib.config["fold_smem_bytes"] if fold else 0)


def _check_fits(name: str, device: int, d: int, fold: bool) -> None:
    """Once per (device, kernel, d, form): each block's shared memory fits
    (K1a: its K12 prologue and, at a fold, the DMMA tiles; K1b: the tiles;
    K2: its staged rows)."""
    key = (device, name, d, fold)
    if key in _FITS:
        return
    need = smem_bytes(name, d, fold)
    limit = _lib().gp_smem_limit(device)
    if need > limit:
        raise RuntimeError(f"{name} needs {need} B of shared memory per block "
                           f"at d={d}; the device allows {limit} B")
    _FITS.add(key)


def _launch(name, dev, *args):
    lib = _lib()
    err = getattr(lib, name)(*args, dev.index, build.current_stream(dev.index))
    if err:
        msg = lib.gp_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def _check_cap_and_block(name, cap, B):
    if cap % 16:
        raise ValueError(f"{name}: the CUDA kernels take a capacity that is a multiple "
                         f"of 16, got {cap}")
    return form(B)


def gp_w(lib, xs, xq, n, m, *, ls2, signal):
    """K1a: w (cap, B) = L⁻¹ K₁₂ (see ``gp_w_plain``).  ``lib`` must hold the
    buffer invariant: lower-triangular, rows and columns ≥ n zero.

    On the card one call builds K₁₂ into a workspace and then runs the
    product in the form ``form(B)`` picks: a fold's DMMA tiles and their
    fix-up (three launches), or a tell's warp per row pair (two); the call
    counts once in ``launches``."""
    cap, d = xs.shape
    B = xq.shape[0]
    if lib.shape != (cap, cap) or xq.shape[1] != d or not 0 <= n <= cap or not 0 <= m <= B:
        raise ValueError(f"gp_w: lib {tuple(lib.shape)}, xs {tuple(xs.shape)}, "
                         f"xq {tuple(xq.shape)}, n={n}, m={m}")
    if _on_cpu("gp_w", lib, xs, xq):
        return gp_w_plain(lib, xs, xq, n, m, ls2=ls2, signal=signal)
    kind = _check_cap_and_block("gp_w", cap, B)
    _check_fits("gp_w", lib.device.index, d, kind == "fold")
    w = torch.empty((cap, B), dtype=F64, device=lib.device)
    ws_len = _lib().gp_workspace(0, cap, B, int(n), lib.device.index)
    ws = torch.empty((ws_len,), dtype=F64, device=lib.device)
    _launch("gp_w", lib.device, lib.data_ptr(), xs.data_ptr(), xq.data_ptr(), w.data_ptr(),
            ws.data_ptr(), ws_len, cap, d, B, int(n), int(m), float(ls2), float(signal))
    gp_w.launches += 1
    gp_w.launches_by_form[kind] += 1
    return w


def gp_g(w, lib, n):
    """K1b: g (B, cap) = wᵀ L⁻¹ over rows < n (see ``gp_g_plain``); ``lib``
    lower-triangular.  A fold is two launches (the DMMA tiles, then the
    fix-up of tiles split between blocks); a tell is two (per-panel
    partials, then their sum in panel order); either counts once."""
    cap, B = w.shape
    if lib.shape != (cap, cap) or not 0 <= n <= cap:
        raise ValueError(f"gp_g: w {tuple(w.shape)}, lib {tuple(lib.shape)}, n={n}")
    if _on_cpu("gp_g", w, lib):
        return gp_g_plain(w, lib, n)
    kind = _check_cap_and_block("gp_g", cap, B)
    _check_fits("gp_g", w.device.index, 0, kind == "fold")
    g = torch.empty((B, cap), dtype=F64, device=w.device)
    ws_len = _lib().gp_workspace(1, cap, B, int(n), w.device.index)
    ws = torch.empty((ws_len,), dtype=F64, device=w.device)
    _launch("gp_g", w.device, w.data_ptr(), lib.data_ptr(), g.data_ptr(), ws.data_ptr(),
            ws_len, cap, B, int(n))
    gp_g.launches += 1
    gp_g.launches_by_form[kind] += 1
    return g


def gp_ehvi(xq, xs, alpha, n, stair, ymd, *, ls2, signal):
    """K2: EHVI of each pool candidate (see ``gp_ehvi_plain``).  xq (P, d),
    xs (cap, d), alpha (cap, 2), stair (3, S), ymd (2, 2) -> (P,).

    On the card one call runs the split partial means (``ehvi_split``'s
    grid) and the sweep (two launches) and counts once in ``launches``;
    the output and the partials share one allocation."""
    P, d = xq.shape
    cap = xs.shape[0]
    if (xs.shape[1] != d or alpha.shape != (cap, 2) or stair.dim() != 2
            or stair.shape[0] != 3 or ymd.shape != (2, 2) or not 0 <= n <= cap):
        raise ValueError(f"gp_ehvi: xq {tuple(xq.shape)}, xs {tuple(xs.shape)}, "
                         f"alpha {tuple(alpha.shape)}, stair {tuple(stair.shape)}, "
                         f"ymd {tuple(ymd.shape)}, n={n}")
    if _on_cpu("gp_ehvi", xq, xs, alpha, stair, ymd):
        return gp_ehvi_plain(xq, xs, alpha, n, stair, ymd, ls2=ls2, signal=signal)
    dev = xq.device
    _check_fits("gp_ehvi", dev.index, d, False)
    G = ehvi_splits(int(n), P, sm_count(dev.index))
    buf = torch.empty((2 * G * P + P,), dtype=F64, device=dev)   # partials, then out
    out = buf[2 * G * P:]
    _launch("gp_ehvi", dev, xq.data_ptr(), xs.data_ptr(), alpha.data_ptr(), stair.data_ptr(),
            ymd.data_ptr(), out.data_ptr(), buf.data_ptr(), 2 * G * P, P, d, int(n),
            stair.shape[1], G, float(ls2), float(signal))
    gp_ehvi.launches += 1
    return out


gp_w.launches = 0      # calls that launched each CUDA kernel in this process
gp_g.launches = 0
gp_ehvi.launches = 0
gp_w.launches_by_form = {"fold": 0, "tell": 0}   # the same calls, by form
gp_g.launches_by_form = {"fold": 0, "tell": 0}


# ---------------------------------------------------------------------------
# the reference's entry points
# ---------------------------------------------------------------------------


def gp_append(xb, lb, lib, n, m, xnew, ils, noise, *, ls2, signal):
    """Rank-append an m-row block (padded to xnew's height B) into the
    buffers, in place (the reference donates them), and return whether the
    new diagonal block is positive definite.

    Mirrors ``repro/kernels/gp_ops.py::gp_append``: K1a and K1b do the two
    triangular applications over active tiles only, the B×B Schur block is
    factored densely, and only the B new rows of L and L⁻¹ are written —
    multiplied by the padding mask, so rows and columns ≥ n + m stay zero.
    ``ils`` is the reciprocal ARD lengthscale row (None when isotropic; then
    ``ls2`` carries ls²).  ``torch.linalg.cholesky_ex`` does not raise on a
    non-PD block, and on CUDA its partial factor need not be NaN, so the
    flag is its ``info`` together with a finite diagonal, read once.
    """
    B = xnew.shape[0]
    dev = xb.device
    if n + B > xb.shape[0]:
        raise ValueError(f"gp_append: rows {n}..{n + B} exceed capacity {xb.shape[0]}")
    bvalid = (torch.arange(B, device=dev) < m).to(F64)
    xnew = xnew * bvalid[:, None]
    xb[n:n + B] = xnew
    if ils is None:
        xs, xqs = xb, xnew
    else:
        xs, xqs = xb * ils[None, :], xnew * ils[None, :]
    w = gp_w(lib, xs, xqs, n, m, ls2=ls2, signal=signal)

    eye = torch.eye(B, dtype=F64, device=dev)
    k22 = tile_kern(xqs, xqs, ls2, signal) + noise * eye
    k22 = k22 * bvalid[:, None] * bvalid[None, :] + torch.diag(1.0 - bvalid)
    l22, info = torch.linalg.cholesky_ex(k22 - w.T @ w)
    ok = (info == 0) & torch.isfinite(torch.diagonal(l22) * bvalid + (1.0 - bvalid)).all()
    li22 = torch.linalg.solve_triangular(l22, eye, upper=False)

    g = gp_g(w, lib, n)
    bmask = bvalid[:, None] * bvalid[None, :]
    lb[n:n + B] = w.T
    lb[n:n + B, n:n + B] = l22 * bmask
    lib[n:n + B] = -((li22 * bmask) @ g)
    lib[n:n + B, n:n + B] = li22 * bmask
    return bool(ok)


def gp_fused_ehvi(xb, alpha, n, xq, stair, ymd, ils, *, ls2, signal):
    """EHVI scores for the whole pool in one K2 launch.  ``stair`` is (3, S):
    the lows/ups/levels rows of the sorted-front staircase, padded with
    zero-width segments; ``ymd`` is (2, 2): the fit's per-target mean/std
    rows.  Returns (P,) hypervolume improvements."""
    if ils is None:
        xs, xqs = xb, xq
    else:
        xs, xqs = xb * ils[None, :], xq * ils[None, :]
    return gp_ehvi(xqs, xs, alpha, n, stair, ymd, ls2=ls2, signal=signal)
