"""K1a, K1b, K2: the incremental GP's tell and ask kernels (``gp_mode="cuda"``).

Replaces the Pallas TPU kernels of ``repro/kernels/gp_ops.py``:

* **K1a** ``gp_w`` (``_w_kernel``): w = L⁻¹·K₁₂ over the active lower
  tiles, with the RBF block K₁₂ built tile by tile from the X rows;
* **K1b** ``gp_g`` (``_g_kernel``): g = wᵀ·L⁻¹ over the active lower tiles;
* **K2** ``gp_ehvi`` (``_ehvi_kernel``): per pool candidate, the posterior
  means of 2 objectives, denormalised, then the EHVI staircase sum, without
  materialising the (P, n) cross-kernel matrix.

``gp_append`` and ``gp_fused_ehvi`` are the reference's two entry points.
Between K1a and K1b the dense B×B Schur block and the slab writes of the
new rows stay ``torch.linalg``/indexing, as the reference leaves them to XLA.

The CUDA kernels are ``csrc/gp_ops.cu`` (built by ``kernels.build`` with nvcc
for ``sm_90a`` and called through ``ctypes``); that file's header says what
bounds each on an H100 and what its design does about it.  Every wrapper
takes its plain PyTorch version for CPU tensors only and, for a CUDA tensor,
launches its kernel or raises; it counts its launches (``gp_w.launches``,
``gp_g.launches``, ``gp_ehvi.launches``) and checks the shared memory it
needs against the device's limit.

All of it is float64.  The kernels' tiles are their own (64 × 64 outputs,
16-row contraction steps; one warp per candidate in K2): the reference's
``block``/``pool_block`` of 256 × 256 float64 (512 KB) do not fit a Hopper
block's 227 KB of shared memory.  ARD lengthscales are handled by the caller
pre-scaling X by ``ils`` with ``ls2 = 1``, as the reference does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

F64 = torch.float64
_KERNEL_IDS = {"gp_w": 0, "gp_g": 1, "gp_ehvi": 2}


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
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("gp_ops")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.gp_w.argtypes = [p] * 4 + [i] * 5 + [f, f, p]
        lib.gp_g.argtypes = [p] * 3 + [i] * 3 + [p]
        lib.gp_ehvi.argtypes = [p] * 6 + [i] * 4 + [f, f, p]
        for fn in (lib.gp_w, lib.gp_g, lib.gp_ehvi):
            fn.restype = i
        lib.gp_smem_bytes.argtypes = [i, i]
        lib.gp_smem_bytes.restype = i
        lib.gp_smem_limit.argtypes = [i]
        lib.gp_smem_limit.restype = i
        lib.gp_error_string.argtypes = [i]
        lib.gp_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def smem_bytes(name: str, d: int) -> int:
    """Dynamic shared memory one block of kernel ``name`` needs at width d."""
    return _lib().gp_smem_bytes(_KERNEL_IDS[name], d)


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
    return False


def _launch(name, dev, d, *args):
    lib = _lib()
    need = lib.gp_smem_bytes(_KERNEL_IDS[name], d)
    limit = lib.gp_smem_limit(dev.index or 0)
    if need <= 0 or need > limit:
        raise RuntimeError(f"{name} needs {need} B of shared memory per block "
                           f"at d={d}; the device allows {limit} B")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        msg = lib.gp_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")


def gp_w(lib, xs, xq, n, m, *, ls2, signal):
    """K1a: w (cap, B) = L⁻¹ K₁₂ (see ``gp_w_plain``).  ``lib`` must hold the
    buffer invariant: lower-triangular, rows and columns ≥ n zero."""
    cap, d = xs.shape
    B = xq.shape[0]
    if lib.shape != (cap, cap) or xq.shape[1] != d or not 0 <= n <= cap or not 0 <= m <= B:
        raise ValueError(f"gp_w: lib {tuple(lib.shape)}, xs {tuple(xs.shape)}, "
                         f"xq {tuple(xq.shape)}, n={n}, m={m}")
    if _on_cpu("gp_w", lib, xs, xq):
        return gp_w_plain(lib, xs, xq, n, m, ls2=ls2, signal=signal)
    w = torch.empty((cap, B), dtype=F64, device=lib.device)
    _launch("gp_w", lib.device, d, lib.data_ptr(), xs.data_ptr(), xq.data_ptr(),
            w.data_ptr(), cap, d, B, int(n), int(m), float(ls2), float(signal))
    gp_w.launches += 1
    return w


def gp_g(w, lib, n):
    """K1b: g (B, cap) = wᵀ L⁻¹ over rows < n (see ``gp_g_plain``); ``lib``
    lower-triangular."""
    cap, B = w.shape
    if lib.shape != (cap, cap) or not 0 <= n <= cap:
        raise ValueError(f"gp_g: w {tuple(w.shape)}, lib {tuple(lib.shape)}, n={n}")
    if _on_cpu("gp_g", w, lib):
        return gp_g_plain(w, lib, n)
    g = torch.empty((B, cap), dtype=F64, device=w.device)
    _launch("gp_g", w.device, 0, w.data_ptr(), lib.data_ptr(), g.data_ptr(),
            cap, B, int(n))
    gp_g.launches += 1
    return g


def gp_ehvi(xq, xs, alpha, n, stair, ymd, *, ls2, signal):
    """K2: EHVI of each pool candidate (see ``gp_ehvi_plain``).  xq (P, d),
    xs (cap, d), alpha (cap, 2), stair (3, S), ymd (2, 2) -> (P,)."""
    P, d = xq.shape
    cap = xs.shape[0]
    if (xs.shape[1] != d or alpha.shape != (cap, 2) or stair.dim() != 2
            or stair.shape[0] != 3 or ymd.shape != (2, 2) or not 0 <= n <= cap):
        raise ValueError(f"gp_ehvi: xq {tuple(xq.shape)}, xs {tuple(xs.shape)}, "
                         f"alpha {tuple(alpha.shape)}, stair {tuple(stair.shape)}, "
                         f"ymd {tuple(ymd.shape)}, n={n}")
    if _on_cpu("gp_ehvi", xq, xs, alpha, stair, ymd):
        return gp_ehvi_plain(xq, xs, alpha, n, stair, ymd, ls2=ls2, signal=signal)
    out = torch.empty((P,), dtype=F64, device=xq.device)
    _launch("gp_ehvi", xq.device, d, xq.data_ptr(), xs.data_ptr(), alpha.data_ptr(),
            stair.data_ptr(), ymd.data_ptr(), out.data_ptr(), P, d, int(n),
            stair.shape[1], float(ls2), float(signal))
    gp_ehvi.launches += 1
    return out


gp_w.launches = 0      # launches of each CUDA kernel in this process
gp_g.launches = 0
gp_ehvi.launches = 0


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
