"""PyTorch incremental GP — the device tier behind ``gp_mode="torch"``.

Port of ``repro/core/search/gp_jax.py``.  ``TorchIncrementalGP`` mirrors the
numpy ``IncrementalGP`` contract (observe / fit_x / fit_y / predict / the
``_multi`` family) but keeps the kernel state on the card as fixed-capacity,
zero-padded float64 buffers:

* **Rank-append Cholesky on the device** — ``observe`` pads the new block to
  a power-of-two width and ``_append`` writes X, extends L with
  ``[[L, 0], [wᵀ, chol(K₂₂ − wᵀw)]]`` and L⁻¹ with the matching block
  inverse.  Buffers double amortizedly exactly like the numpy layout.  The
  padding rows get an identity diagonal (the Cholesky of a block-diag
  ``[[K, 0], [0, I]]`` is ``[[L, 0], [0, I]]``) and are zeroed afterwards,
  keeping the invariant every other product relies on: rows/cols at index
  ≥ n are exactly zero.
* **Fused pool scoring** — ``predict_multi`` / ``predict_mean_multi`` /
  ``score_ehvi`` each run kernel GEMM + solve (+ the EHVI staircase sweep)
  over the whole candidate pool on the device; pools are row-padded to
  powers of two as in the reference.
* **Inducing points (subset-of-data)** — every observation lands in a
  host-side archive, but past ``inducing_threshold`` active points the
  factor is periodically *thinned* back to an evenly-strided subset of the
  archive (overflow factor 1.25), so tell stays O(m²) and ask latency flat
  into the 10⁴–10⁶ regime.  Below the threshold the active set is the full
  archive and the posterior matches the numpy path to float64 round-off.
* **float64 without global flags** — every buffer and every transfer names
  ``dtype=torch.float64``; the process default dtype is never changed.

The reference's jitted functions (``_append_jit``, ``_refactor_jit``,
``_fit_y_jit``, ``_rethin_jit``, ``_predict_jit``, ``_predict_mean_jit``,
``_ehvi_jit``) are plain functions on tensors here; PyTorch runs them
eagerly.  Where the reference donates a buffer, the port updates it in
place.  Dense work stays ``torch.matmul``/``torch.linalg``, as the reference
leaves it to XLA.

``jnp.linalg.cholesky`` signals a non-PD input with NaNs; ``torch.linalg.
cholesky`` raises instead, and on CUDA the partial factor it leaves is not
NaN.  So the append uses ``cholesky_ex`` and returns ``ok = info == 0 and a
finite new diagonal``, read once per append; a degenerate append falls back
to one masked full-capacity refactor (``_refactor``), as in numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.results import nondominated_mask
from repro_torch.core.search.bayesopt import _ls_equal
from repro_torch.device import resolve_device

F64 = torch.float64
KINDS = ("torch", "cuda", "jax", "pallas", "incremental")   # load_state accepts


def _pow2(n: int) -> int:
    p = 16
    while p < n:
        p *= 2
    return p


def _pow2_small(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _ils(ls, device) -> Optional[torch.Tensor]:
    """Reciprocal ARD lengthscale row on ``device``, or None when isotropic."""
    if not np.ndim(ls):
        return None
    return torch.as_tensor(1.0 / np.asarray(ls, float), dtype=F64, device=device)


def _kern(a, b, ls, signal):
    """RBF via ‖a‖² + ‖b‖² − 2a·b — the same GEMM form as the numpy path.

    ``ls`` may be a scalar (isotropic: divide the distances by ls²) or a
    per-dimension (d,) vector (ARD: inputs pre-scaled by the reciprocal
    lengthscales, distances used raw) — the reference's two forms.  Written
    with in-place steps, in the reference's order of operations, so that a
    full-capacity (cap, cap) kernel holds two such buffers at a time."""
    ils = _ils(ls, a.device)
    if ils is None:
        den = float(ls) * float(ls)
    else:
        a, b, den = a * ils, b * ils, 1.0
    dot2 = (a @ b.T).mul_(2.0)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]).sub_(dot2)
    del dot2
    return d2.clamp_min_(0.0).mul_(-0.5).div_(den).exp_().mul_(signal)


def _rows(cap, n, device):
    return (torch.arange(cap, device=device) < n).to(F64)


def _append(xb, lb, lib, n, m, xnew, ls, noise, signal):
    """Rank-append an m-row block (padded to xnew's height B), in place.

    Returns a 0-dim bool tensor: False means the block was not PD (numpy
    raises LinAlgError here) and the caller must refactor."""
    B = xnew.shape[0]
    dev = xb.device
    n2 = n + m
    bvalid = _rows(B, m, dev)
    xb[n:n + B] = xnew * bvalid[:, None]
    # kernel strips against the *valid* rows only (zero-padding ⇒ mask once)
    k12 = _kern(xb, xnew, ls, signal) * _rows(xb.shape[0], n, dev)[:, None] * bvalid[None, :]
    eye = torch.eye(B, dtype=F64, device=dev)
    k22 = _kern(xnew, xnew, ls, signal) + noise * eye
    # padding rows of the block get an identity diagonal so chol is exact
    k22 = k22 * bvalid[:, None] * bvalid[None, :] + torch.diag(1.0 - bvalid)
    w = lib @ k12                                      # (cap, B); L⁻¹K₁₂
    l22, info = torch.linalg.cholesky_ex(k22 - w.T @ w)
    ok = (info == 0) & torch.isfinite(torch.diagonal(l22) * bvalid + (1.0 - bvalid)).all()
    li22 = torch.linalg.solve_triangular(l22, eye, upper=False)
    g = w.T @ lib                                      # before rows n.. change
    lb[n:n + B] = w.T
    lb[n:n + B, n:n + B] = l22
    lib[n:n + B] = -li22 @ g
    lib[n:n + B, n:n + B] = li22
    # restore the zero invariant outside the new valid n2×n2 block (the
    # identity rows of padded appends must not leak into later GEMMs)
    for buf in (lb, lib):
        buf[n2:] = 0.0
        buf[:, n2:] = 0.0
    return ok


def _refactor(xb, n, ls, noise, signal):
    """Masked full-capacity refactor: chol of [[K, 0], [0, I]] then re-zero.

    O(cap³) but called only on degenerate appends, thinning, and
    lengthscale refreshes — all amortized."""
    cap = xb.shape[0]
    mask = _rows(cap, n, xb.device)
    k = _kern(xb, xb, ls, signal).mul_(mask[:, None]).mul_(mask[None, :])
    diag = k.diagonal()
    diag.add_(noise * mask).add_(1.0 - mask)
    lb, _ = torch.linalg.cholesky_ex(k)
    del k, diag
    lib = torch.linalg.solve_triangular(
        lb, torch.eye(cap, dtype=F64, device=xb.device), upper=False)
    # the solvers return column-major results on CUDA; the buffers stay
    # row-major, the layout the kernels read
    lb, lib = lb.contiguous(), lib.contiguous()
    for buf in (lb, lib):
        buf.mul_(mask[:, None]).mul_(mask[None, :])
    return lb, lib


def _fit_y(lib, yn):
    """alpha = L⁻ᵀ L⁻¹ y over the full (zero-padded) capacity."""
    return lib.T @ (lib @ yn)


def _rethin(xb, xrows, m):
    """In-place active-row rebuild for a re-thin at unchanged capacity: the
    buffer is zeroed and the (threshold, d) block (rows ≥ m masked) written
    at the top — no fresh (cap, d) allocation."""
    bvalid = _rows(xrows.shape[0], m, xb.device)
    xb.zero_()
    xb[:xrows.shape[0]] = xrows * bvalid[:, None]
    return xb


def _predict(xb, lib, alpha, n, xq, ls, signal):
    ks = _kern(xq, xb, ls, signal) * _rows(xb.shape[0], n, xb.device)[None, :]
    mu = ks @ alpha                                     # (P, J) normalized
    v = lib @ ks.T
    var = (signal - (v * v).sum(0)).clamp_min(1e-9)
    return mu, var


def _predict_mean(xb, alpha, n, xq, ls, signal):
    return (_kern(xq, xb, ls, signal) * _rows(xb.shape[0], n, xb.device)[None, :]) @ alpha


def _ehvi(xb, alpha, n, xq, front, ref, ym, ysd, ls, signal):
    """Fused: pool kernel GEMM → posterior means → denormalize → staircase
    EHVI sweep over the whole candidate pool.

    ``front`` is the sorted valid front padded with ``(ref[0], y_last)``
    sentinel rows — each contributes a zero-width segment, so the sum
    matches the unpadded numpy staircase exactly."""
    ks = _kern(xq, xb, ls, signal) * _rows(xb.shape[0], n, xb.device)[None, :]
    mu = ks @ alpha * ysd + ym                          # (P, 2) denormalized
    x, y = front[:, 0], front[:, 1]
    neg_inf = torch.full((1,), -np.inf, dtype=F64, device=xb.device)
    lows = torch.cat([neg_inf, x])
    ups = torch.cat([x, ref[0:1]])
    levels = torch.cat([ref[1:2], y])
    width = (ups[None, :] - torch.maximum(lows[None, :], mu[:, 0:1])).clamp_min(0.0)
    height = (levels[None, :] - mu[:, 1:2]).clamp_min(0.0)
    return (width * height).sum(1)


class TorchIncrementalGP:
    """Drop-in for ``IncrementalGP`` with device buffers + inducing points.

    ``inducing_threshold=None`` (or a huge value) keeps every observation
    active — exact numpy parity; with a threshold, ``len(gp)`` is the
    active-set size and ``gp.n_total`` the archive size.  ``device=None``
    means the card (raises when there is none); the tests pass ``"cpu"``.
    """

    kind = "torch"

    def __init__(self, lengthscale=0.3, noise: float = 1e-3,
                 signal: float = 1.0,
                 inducing_threshold: Optional[int] = None,
                 inducing_overflow: float = 1.25, device=None):
        self.device = resolve_device(device)
        self.ls = (np.asarray(lengthscale, float)
                   if np.ndim(lengthscale) else float(lengthscale))
        self.noise = float(noise)
        self.signal = float(signal)
        self.inducing_threshold = inducing_threshold
        self.inducing_overflow = float(inducing_overflow)
        self._n = 0                       # active rows on device
        self._cap = 0
        self._dim = 0
        self._xb = self._lb = self._lib = None
        # full observation archive (host): the thinning source
        self._ax: Optional[np.ndarray] = None
        self._n_all = 0
        self._active_idx = np.zeros(0, np.int64)   # archive row per active row
        self.n_appends = 0
        self.n_refactors = 0
        self.n_thins = 0
        self.n_rethins = 0      # thins that reused the buffers in place
        # fit state (single- and multi-target kept separate, like numpy)
        self._alpha1 = self._ym = self._ys = None
        self._alpha_m = self._ym_m = self._ys_m = None

    def __len__(self) -> int:
        return self._n

    @property
    def n_total(self) -> int:
        return self._n_all

    def _dev(self, a) -> torch.Tensor:
        """Host array → float64 tensor on the GP's device."""
        return torch.as_tensor(np.asarray(a, float), dtype=F64, device=self.device)

    # -- buffers --------------------------------------------------------------
    def _ensure_cap(self, need: int, dim: int) -> None:
        if self._cap >= need and self._dim == dim:
            return
        cap = _pow2(need)
        xb = torch.zeros((cap, dim), dtype=F64, device=self.device)
        lb = torch.zeros((cap, cap), dtype=F64, device=self.device)
        lib = torch.zeros((cap, cap), dtype=F64, device=self.device)
        n = self._n
        if n:
            xb[:n] = self._xb[:n]
            lb[:n, :n] = self._lb[:n, :n]
            lib[:n, :n] = self._lib[:n, :n]
        self._xb, self._lb, self._lib = xb, lb, lib
        self._cap, self._dim = cap, dim
        act = np.zeros(cap, np.int64)
        act[:self._n] = self._active_idx[:self._n]
        self._active_idx = act

    def _archive(self, x_new: np.ndarray) -> np.ndarray:
        m = len(x_new)
        need = self._n_all + m
        if self._ax is None or len(self._ax) < need:
            cap = _pow2(need)
            ax = np.zeros((cap, x_new.shape[1]))
            if self._n_all:
                ax[:self._n_all] = self._ax[:self._n_all]
            self._ax = ax
        self._ax[self._n_all:need] = x_new
        idx = np.arange(self._n_all, need, dtype=np.int64)
        self._n_all = need
        return idx

    # -- incremental growth ---------------------------------------------------
    def observe(self, x_new: np.ndarray) -> "TorchIncrementalGP":
        x_new = np.atleast_2d(np.asarray(x_new, float))
        m = len(x_new)
        if m == 0:
            return self
        idx = self._archive(x_new)
        self._append_active(x_new, idx)
        thr = self.inducing_threshold
        if thr is not None and self._n > int(thr * self.inducing_overflow):
            self._thin()
        return self

    def _padded_block(self, xa: np.ndarray):
        """(B, padded device block) for an m-row append; capacity covers the
        padded block, so the slab writes never run past the buffers."""
        m, d = xa.shape
        B = _pow2_small(m)
        self._ensure_cap(self._n + B, d)
        xpad = np.zeros((B, d))
        xpad[:m] = xa
        return B, self._dev(xpad)

    def _appended(self, m: int, idx: np.ndarray, ok: bool) -> None:
        self._active_idx[self._n:self._n + m] = idx
        self._n += m
        self.n_appends += 1
        if not ok:
            # degenerate block (duplicated rows beyond the noise jitter):
            # same fallback as the numpy LinAlgError path
            self._refactor()

    def _append_active(self, xa: np.ndarray, idx: np.ndarray) -> None:
        _, xpad = self._padded_block(xa)
        ok = _append(self._xb, self._lb, self._lib, self._n, len(xa), xpad,
                     self.ls, self.noise, self.signal)
        self._appended(len(xa), idx, bool(ok))

    def _refactor(self) -> None:
        self._lb = self._lib = None      # free the old pair before the new
        self._lb, self._lib = _refactor(self._xb, self._n, self.ls, self.noise,
                                        self.signal)
        self.n_refactors += 1

    def _thin(self) -> None:
        """Shrink the active set to an evenly-strided archive subset.

        Once the pow2 capacity has settled every thin lands back in the
        same-sized buffers: that case rewrites X in place (``_rethin``,
        threshold-sized transfer) instead of reallocating full-capacity
        device arrays.  ``stats()['rethins']`` counts the in-place ones.
        """
        thr = int(self.inducing_threshold)
        sel = np.unique(np.linspace(0, self._n_all - 1, thr).round()
                        .astype(np.int64))
        xa = self._ax[sel]
        m, d = xa.shape
        if self._xb is not None and self._dim == d and _pow2(m) <= self._cap:
            xpad = np.zeros((thr, d))
            xpad[:m] = xa
            _rethin(self._xb, self._dev(xpad), m)
            self.n_rethins += 1
        else:
            self._n = 0
            self._ensure_cap(m, d)
            self._xb = torch.zeros((self._cap, d), dtype=F64, device=self.device)
            self._xb[:m] = self._dev(xa)
        self._n = m
        self._active_idx[:m] = sel
        self._refactor()
        self.n_thins += 1

    def set_lengthscale(self, ls) -> "TorchIncrementalGP":
        """Hyperparameter refresh: new lengthscale (scalar or per-dimension
        ARD vector), one masked refactor riding the existing device buffers."""
        if _ls_equal(ls, self.ls):
            return self
        new = np.asarray(ls, float)
        self.ls = new if new.ndim else float(new)
        if self._n:
            self._refactor()
        return self

    def fit_x(self, x: np.ndarray) -> "TorchIncrementalGP":
        """Reset and bulk-load (equivalence/refit entry point)."""
        self._n = 0
        self._n_all = 0
        return self.observe(x)

    # -- fits -----------------------------------------------------------------
    def _active_targets(self, Y: np.ndarray) -> np.ndarray:
        """Archive-aligned targets → active subset (SoD selection)."""
        Y = np.asarray(Y, float)
        if len(Y) == self._n:
            return Y
        assert len(Y) == self._n_all, (
            f"targets must align with the archive ({self._n_all}) or the "
            f"active set ({self._n}), got {len(Y)}")
        return Y[self._active_idx[:self._n]]

    def _padded(self, ya: np.ndarray) -> torch.Tensor:
        out = np.zeros((self._cap,) + ya.shape[1:])
        out[:self._n] = ya
        return self._dev(out)

    def fit_y(self, y: np.ndarray) -> "TorchIncrementalGP":
        assert self._n > 0, "observe first"
        ya = self._active_targets(np.asarray(y, float))
        self._ym = float(np.mean(ya))
        self._ys = float(np.std(ya)) or 1.0
        self._alpha1 = _fit_y(self._lib, self._padded((ya - self._ym) / self._ys)[:, None])
        return self

    def fit(self, x: np.ndarray, y: np.ndarray) -> "TorchIncrementalGP":
        return self.fit_x(x).fit_y(y)

    def fit_y_multi(self, Y: np.ndarray) -> "TorchIncrementalGP":
        assert self._n > 0, "observe first"
        ya = self._active_targets(Y)
        self._ym_m = ya.mean(axis=0)
        std = ya.std(axis=0)
        self._ys_m = np.where(std > 0, std, 1.0)
        self._alpha_m = _fit_y(self._lib, self._padded((ya - self._ym_m) / self._ys_m))
        return self

    # -- predicts -------------------------------------------------------------
    def _pad_pool(self, xs: np.ndarray):
        xs = np.atleast_2d(np.asarray(xs, float))
        P = _pow2_small(max(len(xs), 1))
        xq = np.zeros((P, xs.shape[1]))
        xq[:len(xs)] = xs
        # float64 named on the transfer: the reference's comment here is
        # about a silent float32 truncation of the queries, never allowed
        return self._dev(xq), len(xs)

    def predict(self, xs: np.ndarray):
        xq, M = self._pad_pool(xs)
        mu, var = _predict(self._xb, self._lib, self._alpha1, self._n, xq,
                           self.ls, self.signal)
        mu = mu.cpu().numpy()[:M, 0]
        sig = np.sqrt(var.cpu().numpy()[:M])
        return mu * self._ys + self._ym, sig * self._ys

    def predict_multi(self, xs: np.ndarray):
        xq, M = self._pad_pool(xs)
        mu, var = _predict(self._xb, self._lib, self._alpha_m, self._n, xq,
                           self.ls, self.signal)
        mu = mu.cpu().numpy()[:M] * self._ys_m + self._ym_m
        sig = np.sqrt(var.cpu().numpy()[:M])[:, None] * self._ys_m
        return mu, sig

    def predict_mean_multi(self, xs: np.ndarray) -> np.ndarray:
        xq, M = self._pad_pool(xs)
        mu = _predict_mean(self._xb, self._alpha_m, self._n, xq, self.ls, self.signal)
        return mu.cpu().numpy()[:M] * self._ys_m + self._ym_m

    def _front(self, xs, front_y, ref):
        """(pool, valid sorted front padded to pow2 with zero-width
        sentinels, ref), or a pool of None / a front of None for the two
        short cuts of ``score_ehvi``."""
        xs = np.atleast_2d(np.asarray(xs, float))
        if len(xs) == 0:
            return None, None, None
        ref = np.asarray(ref, float)
        front = np.asarray(front_y, float)
        front = front[np.all(front < ref, axis=1)]
        if len(front) == 0:
            return xs, None, ref
        front = front[nondominated_mask(front)]
        front = front[np.argsort(front[:, 0])]
        F = _pow2_small(len(front))
        pad = np.repeat([[ref[0], front[-1, 1]]], F - len(front), axis=0)
        return xs, np.vstack([front, pad]), ref

    def _rectangle_ehvi(self, xs, ref):
        """No valid front: the plain rectangle-to-ref product."""
        mu = self.predict_mean_multi(xs)
        return (np.clip(ref[0] - mu[:, 0], 0.0, None)
                * np.clip(ref[1] - mu[:, 1], 0.0, None))

    def score_ehvi(self, xs: np.ndarray, front_y: np.ndarray,
                   ref: np.ndarray) -> np.ndarray:
        """Fused EHVI over the pool: posterior means + staircase sweep on the
        device (means are *not* round-tripped to the host)."""
        xs, fpad, ref = self._front(xs, front_y, ref)
        if xs is None:
            return np.zeros(0)
        if fpad is None:
            return self._rectangle_ehvi(xs, ref)
        xq, M = self._pad_pool(xs)
        s = _ehvi(self._xb, self._alpha_m, self._n, xq, self._dev(fpad),
                  self._dev(ref), self._dev(self._ym_m), self._dev(self._ys_m),
                  self.ls, self.signal)
        return s.cpu().numpy()[:M]

    def stats(self) -> dict:
        return {"n_active": self._n, "n_total": self._n_all,
                "capacity": self._cap, "appends": self.n_appends,
                "refactors": self.n_refactors, "thins": self.n_thins,
                "rethins": self.n_rethins}

    # -- durable state ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Exported factor + archive for checkpoint/resume, with the keys of
        the reference's ``JaxIncrementalGP.state_dict``.

        The device factor travels as trimmed host-numpy copies — *not* a
        refit on restore, which would reorder float ops and break the
        bit-exact resumed-pick guarantee.  float64 round-trips device→host→
        device losslessly.  Fit caches (``_alpha*``) are recomputed on the
        next ask and not saved.  ``cap`` (a key the reference's states
        lack) is the live buffers' capacity: a restore allocates the same
        one, so every capacity-wide device product of the resumed sweep has
        the uninterrupted sweep's shapes.
        """
        n = self._n

        def host(t):
            return t.cpu().numpy().copy()

        return {"kind": self.kind, "ls": self.ls, "noise": self.noise,
                "signal": self.signal,
                "inducing_threshold": self.inducing_threshold,
                "inducing_overflow": self.inducing_overflow,
                "n": n, "n_all": self._n_all, "cap": self._cap,
                "xb": None if n == 0 else host(self._xb[:n]),
                "lb": None if n == 0 else host(self._lb[:n, :n]),
                "lib": None if n == 0 else host(self._lib[:n, :n]),
                "ax": (None if self._n_all == 0
                       else np.array(self._ax[:self._n_all])),
                "active_idx": np.array(self._active_idx[:n]),
                "n_appends": self.n_appends,
                "n_refactors": self.n_refactors,
                "n_thins": self.n_thins, "n_rethins": self.n_rethins}

    def load_state(self, state: dict) -> "TorchIncrementalGP":
        """Restore a state of this tier, of the other device tier, of the
        reference's ``"jax"``/``"pallas"`` tiers, or a numpy
        ``IncrementalGP.state_dict()`` (``"incremental"``: its rows are the
        whole archive, all active)."""
        kind = state.get("kind")
        if kind not in KINDS:
            raise ValueError(f"cannot load a GP state of kind {kind!r}; "
                             f"want one of {KINDS}")
        if kind == "incremental":
            n = int(state["n"])
            state = dict(state, inducing_threshold=self.inducing_threshold,
                         inducing_overflow=self.inducing_overflow, n_all=n,
                         ax=state["xb"], active_idx=np.arange(n, dtype=np.int64),
                         n_appends=0, n_refactors=0, n_thins=0, n_rethins=0)
        self.ls = state["ls"]
        self.noise = state["noise"]
        self.signal = state["signal"]
        self.inducing_threshold = state["inducing_threshold"]
        self.inducing_overflow = state["inducing_overflow"]
        self._n = self._cap = self._dim = 0
        self._xb = self._lb = self._lib = None
        self._ax = None
        self._n_all = 0
        self._active_idx = np.zeros(0, np.int64)
        n = int(state["n"])
        if state["ax"] is not None:
            ax = np.asarray(state["ax"], float)
            cap = _pow2(len(ax))
            self._ax = np.zeros((cap, ax.shape[1]))
            self._ax[:len(ax)] = ax
            self._n_all = int(state["n_all"])
        if n:
            d = state["xb"].shape[1]
            # zeroed pow2 device buffers, at the saved capacity where the
            # state has one (the reference's states do not)
            self._ensure_cap(max(n, int(state.get("cap", 0))), d)
            self._xb[:n] = self._dev(state["xb"])
            self._lb[:n, :n] = self._dev(state["lb"])
            self._lib[:n, :n] = self._dev(state["lib"])
            self._n = n
            self._active_idx[:n] = np.asarray(state["active_idx"], np.int64)
        self.n_appends = state["n_appends"]
        self.n_refactors = state["n_refactors"]
        self.n_thins = state["n_thins"]
        self.n_rethins = state["n_rethins"]
        self._alpha1 = self._ym = self._ys = None
        self._alpha_m = self._ym_m = self._ys_m = None
        return self
