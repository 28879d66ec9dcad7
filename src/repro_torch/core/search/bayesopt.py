"""Gaussian-process Bayesian optimisation (paper refs [2], [6], [8]).

Multi-objective handling à la ParEGO: each ask draws a random weight vector,
scalarises observed objectives with the augmented Tchebycheff norm, fits a GP
on the normalised ordinal encoding, and maximises Expected Improvement over a
random candidate pool (discrete spaces make gradient ascent pointless).  An
EHVI-greedy variant is also provided: candidates are scored by the exact 2-D
hypervolume improvement of the GP posterior mean.

Batch-aware internals: the GP kernel matrix depends only on the observed
*inputs*, so one Cholesky factorisation (``GP.fit_x``) is shared by every
objective / scalarisation / pick within an ask (``GP.fit_y`` re-solves for
the new targets against the cached factor).  EHVI scoring is one vectorized
incremental-hypervolume sweep over the sorted front for the whole candidate
pool — no per-candidate ``hypervolume_2d`` calls.

Incremental GP (``gp_mode="incremental"``, the default): instead of
refactoring K(X, X) from scratch every ask — O(n³) in observed points —
each ``tell`` appends its row to preallocated (amortized-doubling) kernel /
Cholesky buffers with a rank-append update, O(n²) per new observation.  The
factor is cached across asks and invalidated only by new data, so an ask is
pure O(n²·pool) BLAS.  ``gp_mode="refit"`` keeps the per-ask refactor (the
pre-incremental path, retained for benchmarking and equivalence tests).
``gp_mode="torch"`` moves the same incremental layout onto the card
(``repro_torch.core.search.gp_torch.TorchIncrementalGP``, the counterpart of
the reference's ``"jax"`` mode): float64 rank-appends into pow2 device
buffers, fused pool scoring, and a subset-of-data inducing-point
approximation past ``inducing_threshold`` points so ask latency stays flat
at 10⁴+ observations.  ``gp_mode="cuda"`` (the counterpart of ``"pallas"``)
keeps that layout but swaps the two hot device calls for hand-written CUDA
kernels (``repro_torch.core.search.gp_cuda.CudaIncrementalGP``): the
rank-append Cholesky runs its triangular work over active-row tiles only
(O(n·block) per tell, not O(capacity²)) and the EHVI pool sweep fuses
kernel, mean and staircase without materializing the (pool, n)
cross-kernel matrix — the n = 10⁵–10⁶ tier.  The numpy path is the
reference; the device paths match it to float64 round-off while the active
set is exact.  Both device modes run on the card unless the searcher is
given ``device="cpu"``.
Candidate pools come from the vectorized ``SearchAlgorithm._fresh_pool``
(one ``sample_index_batch`` sweep, no config-at-a-time Python loop).

Hyperparameter refresh (``hyper_refresh_every=k``, any mode): every k tells
the RBF lengthscale is re-tuned on a strided subsample (median-distance
heuristic candidates scored by Gaussian log marginal likelihood —
``tune_lengthscale``) and the live factor is rebuilt *in place* via
``set_lengthscale`` — one refactor riding the existing buffers, not a
rebuild of the searcher.  The candidate grid covers isotropic scales *and*
per-dimension (ARD) median-distance vectors; when an ARD candidate scores
strictly higher, ``set_lengthscale`` adopts the vector in every gp mode
(inputs are pre-scaled by the reciprocal lengthscales — the same kernel
form in the numpy, torch, and cuda implementations, preserving parity).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.search.base import SearchAlgorithm
from repro_torch.core.search.hypervolume import hypervolume_2d
from repro_torch.core.results import nondominated_mask

GP_MODES = ("incremental", "refit", "torch", "cuda")
# device-resident surrogates (shared JaxIncrementalGP buffer layout) vs the
# modes that stream tells into a persistent factor (vs per-ask refit)
DEVICE_GP_MODES = ("torch", "cuda")
STREAM_GP_MODES = ("incremental",) + DEVICE_GP_MODES

DEFAULT_LENGTHSCALE = 0.3


def _ls_equal(a, b) -> bool:
    """Lengthscale equality across the scalar/ARD-vector forms."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    return a.shape == b.shape and bool(np.all(a == b))


def _make_surrogate(gp_mode: str, inducing_threshold: Optional[int],
                    device=None):
    """The persistent surrogate for a searcher: numpy incremental buffers, or
    a device-resident twin on ``device`` (None: the card), imported lazily so
    the numpy modes never load torch."""
    if gp_mode == "torch":
        from repro_torch.core.search.gp_torch import TorchIncrementalGP

        return TorchIncrementalGP(inducing_threshold=inducing_threshold,
                                  device=device)
    if gp_mode == "cuda":
        from repro_torch.core.search.gp_cuda import CudaIncrementalGP

        return CudaIncrementalGP(inducing_threshold=inducing_threshold,
                                 device=device)
    return IncrementalGP()


def tune_lengthscale(xs: np.ndarray, ys: np.ndarray, current,
                     noise: float = 1e-3, signal: float = 1.0,
                     max_points: int = 256):
    """Re-tune the RBF lengthscale on a strided subsample, deterministically.

    Isotropic candidates are the median positive pairwise distance of the
    subsample and its half/double (plus a scalar incumbent); ARD candidates
    are the *per-dimension* median-distance vector and its half/double (plus
    a vector incumbent).  Each is scored by the Gaussian log marginal
    likelihood summed over per-column-standardized target columns, so the
    schedule needs no gradient machinery and costs one small O(m³)
    factorisation per candidate (m ≤ ``max_points``).  Isotropic candidates
    are scored first and an ARD vector must win *strictly*, so the historic
    scalar result is unchanged unless per-dimension scaling genuinely
    explains the data better.  Returns a float or a (d,) vector accordingly;
    the incumbent is returned unchanged when there is too little data.
    """
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    if ys.ndim == 1:
        ys = ys[:, None]
    cur = np.asarray(current, float)
    incumbent = cur if cur.ndim else float(cur)
    n = len(xs)
    if n < 4:
        return incumbent
    sel = np.unique(np.linspace(0, n - 1, min(n, max_points)).round()
                    .astype(int))
    x, Y = xs[sel], ys[sel]
    m = len(x)
    sq = np.einsum("ij,ij->i", x, x)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
    pos = d2[np.triu_indices(m, 1)]
    pos = pos[pos > 0]
    if not len(pos):
        return incumbent
    med = float(np.sqrt(np.median(pos)))
    scalars = ([] if cur.ndim else [float(cur)]) + [0.5 * med, med, 2.0 * med]
    scalars = sorted({round(float(c), 6) for c in scalars if c > 1e-6})
    # per-dimension medians; constant dimensions inherit the isotropic median
    iu = np.triu_indices(m, 1)
    per = (x[:, None, :] - x[None, :, :])[iu] ** 2         # (pairs, d)
    med_d = np.empty(x.shape[1])
    for k in range(x.shape[1]):
        pk = per[:, k][per[:, k] > 0]
        med_d[k] = float(np.sqrt(np.median(pk))) if len(pk) else med
    med_d = np.where(med_d > 1e-6, med_d, med)
    vectors = [np.round(f * med_d, 6) for f in (0.5, 1.0, 2.0)]
    if cur.ndim:
        vectors.append(np.round(cur, 6))
    std = Y.std(axis=0)
    yn = (Y - Y.mean(axis=0)) / np.where(std > 0, std, 1.0)

    def _log_ml(ls):
        ls = np.asarray(ls, float)
        if ls.ndim:
            # ARD: pre-scale by reciprocal lengthscales, raw distances —
            # the same kernel form as the numpy/torch/cuda GP implementations
            xr = x * (1.0 / ls)
            sqr = np.einsum("ij,ij->i", xr, xr)
            dd = np.maximum(sqr[:, None] + sqr[None, :] - 2.0 * (xr @ xr.T),
                            0.0)
            k = signal * np.exp(-0.5 * dd) + noise * np.eye(m)
        else:
            k = signal * np.exp(-0.5 * d2 / float(ls) ** 2) + noise * np.eye(m)
        try:
            L = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            return None
        a = np.linalg.solve(L, yn)
        # log ML up to constants: -½ yᵀK⁻¹y - J·log|L|, summed over columns
        return (-0.5 * float(np.sum(a * a))
                - Y.shape[1] * float(np.sum(np.log(np.diag(L)))))

    best_ls, best_ml = incumbent, -np.inf
    for ls in scalars:
        ml = _log_ml(ls)
        if ml is not None and ml > best_ml:
            best_ml, best_ls = ml, ls
    seen_vecs = set()
    for ls in vectors:
        key = tuple(ls.tolist())
        if key in seen_vecs:
            continue
        seen_vecs.add(key)
        ml = _log_ml(ls)
        if ml is not None and ml > best_ml:
            best_ml, best_ls = ml, ls
    return best_ls


class GP:
    """Tiny RBF-kernel GP with observation noise (pure numpy).

    ``fit_x`` factors the kernel matrix once; ``fit_y`` solves for new
    targets against the cached Cholesky factor, so a batch ask that predicts
    several target vectors on the same observations pays for one
    factorisation total.
    """

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-3,
                 signal: float = 1.0):
        self.ls = lengthscale
        self.noise = noise
        self.signal = signal
        self._x: Optional[np.ndarray] = None

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        a = np.asarray(a, float)
        b = np.asarray(b, float)
        ls = np.asarray(self.ls, float)
        if ls.ndim:                       # ARD: reciprocal pre-scale, raw d²
            a = a * (1.0 / ls)
            b = b * (1.0 / ls)
            den = 1.0
        else:                             # isotropic: historical bit-exact form
            den = self.ls ** 2
        d2 = np.sum((a[:, None, :] - b[None, :, :]) ** 2, -1)
        return self.signal * np.exp(-0.5 * d2 / den)

    def fit_x(self, x: np.ndarray) -> "GP":
        """Factor K(x, x) + σ²I once; reusable across any number of targets."""
        self._x = x
        k = self._k(x, x) + self.noise * np.eye(len(x))
        self._l = np.linalg.cholesky(k)
        return self

    def fit_y(self, y: np.ndarray) -> "GP":
        """Solve for a target vector against the cached Cholesky factor."""
        assert self._x is not None, "fit_x first"
        self._ym = float(np.mean(y))
        self._ys = float(np.std(y)) or 1.0
        yn = (y - self._ym) / self._ys
        self._alpha = np.linalg.solve(self._l.T, np.linalg.solve(self._l, yn))
        return self

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GP":
        return self.fit_x(x).fit_y(y)

    def predict(self, xs: np.ndarray):
        ks = self._k(xs, self._x)
        mu = ks @ self._alpha
        v = np.linalg.solve(self._l, ks.T)
        var = np.clip(self.signal - np.sum(v * v, axis=0), 1e-9, None)
        return mu * self._ys + self._ym, np.sqrt(var) * self._ys

    def set_lengthscale(self, ls) -> "GP":
        """Adopt a re-tuned lengthscale (scalar or per-dimension ARD
        vector); refactors in place if already fit."""
        new = np.asarray(ls, float)
        self.ls = new if new.ndim else float(new)
        if self._x is not None:
            self.fit_x(self._x)
        return self

    # -- durable state -------------------------------------------------------
    def state_dict(self) -> dict:
        """Picklable snapshot; fit caches are recomputed at the next ask."""
        return {"kind": "gp", "ls": self.ls, "noise": self.noise,
                "signal": self.signal,
                "x": None if self._x is None else np.array(self._x)}

    def load_state(self, state: dict) -> "GP":
        self.ls = state["ls"]
        self.noise = state["noise"]
        self.signal = state["signal"]
        if state["x"] is not None:
            self.fit_x(state["x"])
        else:
            self._x = None
        return self


class IncrementalGP(GP):
    """GP grown one ``tell`` at a time: rank-append Cholesky, O(n²)/update.

    ``observe(x_new)`` appends m rows to preallocated amortized-doubling
    buffers for X, the kernel matrix K, the Cholesky factor L, and L⁻¹.
    With L⁻¹ maintained explicitly, the append's triangular solve
    ``w = L₁₁⁻¹ K₁₂`` and every downstream ``fit_y``/``predict`` solve are
    plain matmuls — O(n²) BLAS with no LAPACK refactor anywhere on the hot
    path (numpy has no triangular solve; ``np.linalg.solve`` would LU-factor
    the triangle at O(n³) again).  The factor persists across asks and only
    new data extends it, so an ask after t tells costs O(n²·pool) instead of
    the O(n³) ``fit_x`` refactor.  A numerically degenerate append (exactly
    duplicated rows beyond what the noise jitter absorbs) falls back to one
    full refactor — still amortized.
    """

    def __init__(self, lengthscale: float = 0.3, noise: float = 1e-3,
                 signal: float = 1.0):
        super().__init__(lengthscale, noise, signal)
        self._n = 0
        self._cap = 0
        self._xb = self._kb = self._lb = self._lib = None

    def __len__(self) -> int:
        return self._n

    def _grow(self, need: int, dim: int) -> None:
        if self._cap >= need:
            return
        cap = max(self._cap, 16)
        while cap < need:
            cap *= 2
        xb = np.zeros((cap, dim))
        kb = np.zeros((cap, cap))
        lb = np.zeros((cap, cap))
        lib = np.zeros((cap, cap))
        n = self._n
        if n:
            xb[:n] = self._xb[:n]
            kb[:n, :n] = self._kb[:n, :n]
            lb[:n, :n] = self._lb[:n, :n]
            lib[:n, :n] = self._lib[:n, :n]
        self._xb, self._kb, self._lb, self._lib = xb, kb, lb, lib
        self._cap = cap

    def _sync_views(self) -> None:
        n = self._n
        self._x = self._xb[:n]
        self._l = self._lb[:n, :n]
        self._li = self._lib[:n, :n]

    def _refactor(self) -> None:
        """Full O(n³) rebuild of L and L⁻¹ from the stored kernel matrix."""
        n = self._n
        self._lb[:n, :n] = np.linalg.cholesky(self._kb[:n, :n])
        self._lib[:n, :n] = np.linalg.solve(self._lb[:n, :n], np.eye(n))

    def observe(self, x_new: np.ndarray) -> "IncrementalGP":
        """Append m observation inputs; O(n²·m) against the cached factor."""
        x_new = np.atleast_2d(np.asarray(x_new, float))
        m = len(x_new)
        if m == 0:
            return self
        n = self._n
        self._grow(n + m, x_new.shape[1])
        # the kernel matrix grows in place
        k12 = self._k(self._xb[:n], x_new)                    # (n, m)
        k22 = self._k(x_new, x_new) + self.noise * np.eye(m)
        self._xb[n:n + m] = x_new
        self._kb[:n, n:n + m] = k12
        self._kb[n:n + m, :n] = k12.T
        self._kb[n:n + m, n:n + m] = k22
        self._n = n + m
        # rank-append: L_new = [[L, 0], [wᵀ, chol(K₂₂ - wᵀw)]]
        w = self._lib[:n, :n] @ k12                           # (n, m)
        try:
            l22 = np.linalg.cholesky(k22 - w.T @ w)
        except np.linalg.LinAlgError:
            self._refactor()
            self._sync_views()
            return self
        li22 = np.linalg.solve(l22, np.eye(m))                # m is tiny
        self._lb[n:n + m, :n] = w.T
        self._lb[n:n + m, n:n + m] = l22
        self._lib[n:n + m, :n] = -li22 @ (w.T @ self._lib[:n, :n])
        self._lib[n:n + m, n:n + m] = li22
        self._sync_views()
        return self

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """RBF kernel via ‖a‖² + ‖b‖² − 2a·b — one GEMM instead of the
        (N, M, K) subtract/square/sum broadcast.  Same values to fp round-
        off; the GEMM releases the GIL, which is what lets the async
        SearchDriver genuinely overlap GP math with client evaluation."""
        a = np.asarray(a, float)
        b = np.asarray(b, float)
        ls = np.asarray(self.ls, float)
        if ls.ndim:                       # ARD: reciprocal pre-scale, raw d²
            a = a * (1.0 / ls)
            b = b * (1.0 / ls)
            den = 1.0
        else:                             # isotropic: historical bit-exact form
            den = self.ls ** 2
        d2 = (np.einsum("ij,ij->i", a, a)[:, None]
              + np.einsum("ij,ij->i", b, b)[None, :] - 2.0 * (a @ b.T))
        np.maximum(d2, 0.0, out=d2)
        return self.signal * np.exp(-0.5 * d2 / den)

    def fit_x(self, x: np.ndarray) -> "IncrementalGP":
        """Reset and bulk-load (equivalence/refit entry point)."""
        self._n = 0
        return self.observe(x)

    def fit_y(self, y: np.ndarray) -> "IncrementalGP":
        assert self._n > 0, "observe first"
        self._ym = float(np.mean(y))
        self._ys = float(np.std(y)) or 1.0
        yn = (y - self._ym) / self._ys
        self._alpha = self._li.T @ (self._li @ yn)
        return self

    def predict(self, xs: np.ndarray):
        ks = self._k(xs, self._x)
        mu = ks @ self._alpha
        v = self._li @ ks.T
        var = np.clip(self.signal - np.sum(v * v, axis=0), 1e-9, None)
        return mu * self._ys + self._ym, np.sqrt(var) * self._ys

    # -- multi-target path: one kernel sweep for every objective ------------
    def fit_y_multi(self, Y: np.ndarray) -> "IncrementalGP":
        """Solve for all J target columns at once against the cached factor
        (the per-objective ``fit_y``/``predict`` pairs each recomputed the
        candidate kernel block — the dominant per-ask cost)."""
        assert self._n > 0, "observe first"
        Y = np.asarray(Y, float)
        self._ym_m = Y.mean(axis=0)
        std = Y.std(axis=0)
        self._ys_m = np.where(std > 0, std, 1.0)
        yn = (Y - self._ym_m) / self._ys_m
        self._alpha_m = self._li.T @ (self._li @ yn)          # (n, J)
        return self

    def predict_multi(self, xs: np.ndarray):
        """(mu, sigma), each (M, J), from one ``_k``/solve sweep."""
        ks = self._k(xs, self._x)
        mu = ks @ self._alpha_m * self._ys_m + self._ym_m
        v = self._li @ ks.T
        var = np.clip(self.signal - np.sum(v * v, axis=0), 1e-9, None)
        return mu, np.sqrt(var)[:, None] * self._ys_m

    def predict_mean_multi(self, xs: np.ndarray) -> np.ndarray:
        """Posterior means only — skips the (n, M) variance solve that
        EHVI scoring (means-greedy) never uses."""
        return self._k(xs, self._x) @ self._alpha_m * self._ys_m + self._ym_m

    def set_lengthscale(self, ls) -> "IncrementalGP":
        """Adopt a re-tuned lengthscale (scalar or ARD vector) riding the
        existing buffers: the stored kernel matrix is recomputed in place
        and refactored once — no searcher rebuild, no buffer reallocation."""
        if _ls_equal(ls, self.ls):
            return self
        new = np.asarray(ls, float)
        self.ls = new if new.ndim else float(new)
        n = self._n
        if n:
            self._kb[:n, :n] = (self._k(self._xb[:n], self._xb[:n])
                                + self.noise * np.eye(n))
            self._refactor()
            self._sync_views()
        return self

    # -- durable state -------------------------------------------------------
    def state_dict(self) -> dict:
        """Trimmed copies of the incremental buffers — the factor itself is
        saved, not refit, so a restore continues the rank-append sequence
        bit-exactly (a refit would reorder the float ops)."""
        n = self._n
        return {"kind": "incremental", "ls": self.ls, "noise": self.noise,
                "signal": self.signal, "n": n,
                "xb": None if n == 0 else np.array(self._xb[:n]),
                "kb": None if n == 0 else np.array(self._kb[:n, :n]),
                "lb": None if n == 0 else np.array(self._lb[:n, :n]),
                "lib": None if n == 0 else np.array(self._lib[:n, :n])}

    def load_state(self, state: dict) -> "IncrementalGP":
        self.ls = state["ls"]
        self.noise = state["noise"]
        self.signal = state["signal"]
        self._n = self._cap = 0
        self._xb = self._kb = self._lb = self._lib = None
        n = state["n"]
        if n:
            self._grow(n, state["xb"].shape[1])
            self._xb[:n] = state["xb"]
            self._kb[:n, :n] = state["kb"]
            self._lb[:n, :n] = state["lb"]
            self._lib[:n, :n] = state["lib"]
            self._n = n
            self._sync_views()
        return self


# ---------------------------------------------------------------------------
# normal CDF/PDF — pure numpy, no per-ask scipy import on the hot path
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz & Stegun 7.1.26, |err| < 1.5e-7)."""
    x = np.asarray(x, float)
    sign = np.sign(x)
    a = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * np.exp(-a * a))


def norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(np.asarray(z, float) / _SQRT2))


def norm_pdf(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, float)
    return _INV_SQRT_2PI * np.exp(-0.5 * z * z)


def expected_improvement(mu: np.ndarray, sigma: np.ndarray, best: float) -> np.ndarray:
    z = (best - mu) / sigma
    return (best - mu) * norm_cdf(z) + sigma * norm_pdf(z)


def ehvi_improvements(ys: np.ndarray, ref: np.ndarray,
                      cand: np.ndarray) -> np.ndarray:
    """Exact 2-D hypervolume improvement of each candidate over the front.

    One vectorized staircase sweep for the whole ``(M, 2)`` candidate set:
    the nondominated front of ``ys`` (sorted by the first objective) defines
    x-segments with constant cover height; a candidate's improvement is the
    sum over segments of (uncovered width) × (uncovered height).  Equals
    ``hypervolume_2d(ys ∪ {c}, ref) - hypervolume_2d(ys, ref)`` per
    candidate, without M front re-sweeps.
    """
    cand = np.asarray(cand, float)
    ys = np.asarray(ys, float)
    ref = np.asarray(ref, float)
    front = ys[np.all(ys < ref, axis=1)]
    if len(front) == 0:
        return (np.clip(ref[0] - cand[:, 0], 0.0, None)
                * np.clip(ref[1] - cand[:, 1], 0.0, None))
    front = front[nondominated_mask(front)]
    front = front[np.argsort(front[:, 0])]
    x, y = front[:, 0], front[:, 1]          # x ascending ⇒ y descending
    # segment j covers [lows[j], ups[j]) with the front covering y-range
    # [levels[j], ref1]; j = 0 is the uncovered strip left of the front
    lows = np.concatenate(([-np.inf], x))
    ups = np.concatenate((x, ref[0:1]))
    levels = np.concatenate((ref[1:2], y))
    width = np.clip(ups[None, :] - np.maximum(lows[None, :], cand[:, 0:1]),
                    0.0, None)
    height = np.clip(levels[None, :] - cand[:, 1:2], 0.0, None)
    return np.sum(width * height, axis=1)


def _ehvi_improvements_loop(ys: np.ndarray, ref: np.ndarray,
                            cand: np.ndarray) -> np.ndarray:
    """Reference per-candidate implementation (kept for equivalence tests)."""
    base = hypervolume_2d(ys, ref)
    return np.asarray([hypervolume_2d(np.vstack([ys, m[None]]), ref) - base
                       for m in cand])


class BayesOpt(SearchAlgorithm):
    def __init__(self, space, seed: int = 0, n_init: int = 12,
                 pool_size: int = 512, strategy: str = "parego",
                 gp_mode: str = "incremental",
                 hyper_refresh_every: Optional[int] = None,
                 inducing_threshold: Optional[int] = 5000, device=None):
        super().__init__(space, seed)
        self.n_init = n_init
        self.pool_size = pool_size
        assert strategy in ("parego", "ehvi")
        assert gp_mode in GP_MODES
        self.strategy = strategy
        self.gp_mode = gp_mode
        self.hyper_refresh_every = hyper_refresh_every
        self._gp = _make_surrogate(gp_mode, inducing_threshold, device)
        self._gp_pending: List[np.ndarray] = []
        self._front_y: Optional[np.ndarray] = None   # maintained Pareto front
        self._seen = set()
        self._ls = DEFAULT_LENGTHSCALE        # refit-mode tuned lengthscale
        self._last_refresh = 0
        self.n_hyper_refreshes = 0

    def tell(self, knobs: Dict, y: np.ndarray) -> None:
        super().tell(knobs, y)
        if self.gp_mode in STREAM_GP_MODES:
            # queued for a single block rank-append at the next ask boundary
            # (one O(n²·m) BLAS append for m tells instead of m tiny ones)
            self._gp_pending.append(self.space.encode(knobs))
            self._update_front(np.asarray(y, float))

    # -- durable state: swap the live surrogate for its exported buffers ----
    # (explicit base-class calls, not super(): PAL aliases these methods)
    _STATE_SKIP = SearchAlgorithm._STATE_SKIP + ("_gp",)

    def _state_attrs(self) -> Dict:
        attrs = dict(SearchAlgorithm._state_attrs(self))
        attrs["_gp_state"] = self._gp.state_dict()
        return attrs

    def _load_attrs(self, attrs: Dict) -> None:
        attrs = dict(attrs)
        gp_state = attrs.pop("_gp_state", None)
        SearchAlgorithm._load_attrs(self, attrs)
        if gp_state is not None:
            self._gp.load_state(gp_state)

    def _maybe_refresh(self, gp, ys: np.ndarray):
        """The hyperparameter refresh schedule: every ``hyper_refresh_every``
        tells, re-tune the lengthscale and rebuild the live factor in place
        (``set_lengthscale``); refit mode carries the tuned value into its
        next per-ask factorisation instead."""
        every = self.hyper_refresh_every
        if not every or len(self.history_x) - self._last_refresh < every:
            return gp
        self._last_refresh = len(self.history_x)
        current = self._ls if self.gp_mode == "refit" else gp.ls
        ls = tune_lengthscale(self.observed_points(), ys, current)
        self.n_hyper_refreshes += 1
        if self.gp_mode == "refit":
            if not _ls_equal(ls, self._ls):
                self._ls = ls
                return GP(lengthscale=ls).fit_x(self.observed_points())
            return gp
        return gp.set_lengthscale(ls)

    def _update_front(self, y: np.ndarray) -> None:
        """O(front) incremental Pareto update, so EHVI asks never rescan all
        n observations for the nondominated set."""
        if self._front_y is None or self._front_y.shape[1] != len(y):
            self._front_y = y[None, :]
            return
        f = self._front_y
        le = np.all(f <= y, axis=1)
        if np.any(le & np.any(f < y, axis=1)):
            return                                   # dominated: front unchanged
        if np.any(le & np.all(y <= f, axis=1)):
            return                                   # exact duplicate of a
        keep = ~(np.all(y <= f, axis=1) & np.any(y < f, axis=1))   # front row
        self._front_y = np.vstack([f[keep], y[None, :]])

    def _surrogate(self) -> GP:
        """The ask-time GP: the cached incremental factor — extended by one
        rank-append over the tells since the last ask, invalidated only by
        new data — or, in refit mode, a fresh O(n³) factorisation (the
        pre-incremental path, kept for benchmarking and equivalence)."""
        if self.gp_mode in STREAM_GP_MODES:
            if self._gp_pending:
                self._gp.observe(np.stack(self._gp_pending))
                self._gp_pending.clear()
            return self._gp
        return GP(lengthscale=self._ls).fit_x(self.observed_points())

    def _scalarise(self, ys: np.ndarray) -> np.ndarray:
        lo, hi = ys.min(0), ys.max(0)
        z = (ys - lo) / np.where(hi - lo > 0, hi - lo, 1.0)
        w = self.rng.dirichlet(np.ones(ys.shape[1]))
        return np.max(w * z, axis=1) + 0.05 * np.sum(w * z, axis=1)

    def _take_best(self, idx: np.ndarray, flats: np.ndarray,
                   order: np.ndarray, n: int, out: List[Dict]) -> None:
        """Append up to n unseen pool members in score order, pad randomly.

        The pool stays arrays throughout scoring; only the few configs
        actually picked are decoded to knob dicts here."""
        for i in order:
            if len(out) >= n:
                return
            f = int(flats[i])
            if f not in self._seen:
                self._seen.add(f)
                out.append(self.space.index_decode(idx[i]))
        while len(out) < n:
            out.append(self.space.sample(self.rng))

    def ask(self, n: int) -> List[Dict]:
        out: List[Dict] = []
        ys = self.observed_values()
        if len(self.history_x) < self.n_init:
            while len(out) < n:
                c = self.space.sample(self.rng)
                k = self._flat_key(c)
                if k not in self._seen:
                    self._seen.add(k)
                    out.append(c)
            return out

        idx, xp, flats = self._fresh_pool(self.pool_size, exclude=self._seen)
        gp = self._surrogate()   # one cached/derived factor for every pick
        gp = self._maybe_refresh(gp, ys)

        if self.strategy == "ehvi" and ys.shape[1] == 2:
            # posterior means per objective (shared factor), then one
            # vectorized incremental-HVI sweep scores the whole pool; the
            # scores do not change between picks, so the n picks are simply
            # the n best-scoring unseen candidates
            ref = ys.max(0) * 1.1 + 1e-9
            if self.gp_mode in DEVICE_GP_MODES:
                # fully fused on device: kernel GEMM, posterior means, and
                # the staircase sweep happen in one device call — no (M, 2)
                # means matrix ever lands on the host (cuda mode runs it
                # as one hand-written kernel, K2)
                gp.fit_y_multi(ys)
                score = gp.score_ehvi(xp, self._front_y, ref)
            elif self.gp_mode == "incremental":
                # one mean-only kernel sweep for both objectives, scored
                # against the maintained front (same staircase as passing
                # all of ys: ehvi reduces to the nondominated set anyway)
                mus = gp.fit_y_multi(ys).predict_mean_multi(xp)
                score = ehvi_improvements(self._front_y, ref, mus)
            else:
                mus = np.stack([gp.fit_y(ys[:, j]).predict(xp)[0]
                                for j in range(ys.shape[1])], axis=1)
                score = ehvi_improvements(ys, ref, mus)
            self._take_best(idx, flats, np.argsort(-score), n, out)
            return out

        for _ in range(n):   # parego: fresh scalarisation per pick
            s = self._scalarise(ys)
            mu, sig = gp.fit_y(s).predict(xp)
            score = expected_improvement(mu, sig, float(np.min(s)))
            self._take_best(idx, flats, np.argsort(-score), len(out) + 1, out)
        return out


def pal_maybe_pareto(ys: np.ndarray, lcb: np.ndarray) -> np.ndarray:
    """Vectorized "potentially Pareto-optimal" mask for PAL.

    True where a candidate's optimistic (LCB) objective vector is not
    dominated by any observed point — one ``(M, N, K)`` broadcast instead of
    a Python loop over the pool.
    """
    dom = (np.all(ys[None, :, :] <= lcb[:, None, :], axis=2)
           & np.any(ys[None, :, :] < lcb[:, None, :], axis=2))
    return ~np.any(dom, axis=1)


def _pal_maybe_pareto_loop(ys: np.ndarray, lcb: np.ndarray) -> np.ndarray:
    """Reference list-comprehension version (kept for equivalence tests)."""
    return np.asarray([
        not np.any(np.all(ys <= l, axis=1) & np.any(ys < l, axis=1))
        for l in lcb])


class PAL(SearchAlgorithm):
    """ε-PAL-lite (Zuluaga et al., ICML 2013 — the paper's reference [4]):
    GP per objective; sample the candidate whose posterior uncertainty is
    largest among points that could still be Pareto-optimal.

    Mean-only fast path (``mean_only=True``, incremental mode): like the
    real ε-PAL, a candidate whose optimistic (LCB) objective box was found
    dominated is *classified* — ruled out of the race permanently.  When
    such a point re-enters a later candidate pool, its posterior is taken
    from ``IncrementalGP.predict_mean_multi`` — means only, skipping the
    ``(n, M)`` variance solve that dominates predict cost — and it scores
    zero sampling width, so it can never outrank an unclassified candidate.
    ``n_mean_only`` counts pool rows that rode the fast path.
    """

    def __init__(self, space, seed: int = 0, n_init: int = 12,
                 pool_size: int = 512, beta: float = 1.8,
                 gp_mode: str = "incremental", mean_only: bool = True,
                 hyper_refresh_every: Optional[int] = None,
                 inducing_threshold: Optional[int] = 5000, device=None):
        super().__init__(space, seed)
        self.n_init = n_init
        self.pool_size = pool_size
        self.beta = beta
        assert gp_mode in GP_MODES
        self.gp_mode = gp_mode
        self.mean_only = mean_only
        self.hyper_refresh_every = hyper_refresh_every
        self._gp = _make_surrogate(gp_mode, inducing_threshold, device)
        self._gp_pending: List[np.ndarray] = []
        self._seen = set()
        self._ruled_out: set = set()          # flat keys classified not-Pareto
        self._ruled_out_arr: Optional[np.ndarray] = None
        self.n_mean_only = 0
        self._ls = DEFAULT_LENGTHSCALE        # refit-mode tuned lengthscale
        self._last_refresh = 0
        self.n_hyper_refreshes = 0

    def tell(self, knobs: Dict, y: np.ndarray) -> None:
        super().tell(knobs, y)
        if self.gp_mode in STREAM_GP_MODES:
            self._gp_pending.append(self.space.encode(knobs))

    _maybe_refresh = BayesOpt._maybe_refresh

    # durable state: same surrogate-swap as BayesOpt
    _STATE_SKIP = SearchAlgorithm._STATE_SKIP + ("_gp",)
    _state_attrs = BayesOpt._state_attrs
    _load_attrs = BayesOpt._load_attrs

    def _classified_mask(self, flats: np.ndarray) -> np.ndarray:
        if not self._ruled_out:
            return np.zeros(len(flats), bool)
        if self._ruled_out_arr is None or \
                len(self._ruled_out_arr) != len(self._ruled_out):
            self._ruled_out_arr = np.fromiter(
                self._ruled_out, np.int64, len(self._ruled_out))
        return np.isin(flats, self._ruled_out_arr)

    def ask(self, n: int) -> List[Dict]:
        out: List[Dict] = []
        ys = self.observed_values()
        if len(self.history_x) < self.n_init:
            while len(out) < n:
                c = self.space.sample(self.rng)
                k = self._flat_key(c)
                if k not in self._seen:
                    self._seen.add(k)
                    out.append(c)
            return out

        idx, xp, flats = self._fresh_pool(self.pool_size, exclude=self._seen)
        # shared (cached in incremental mode) factor across per-objective fits
        if self.gp_mode in STREAM_GP_MODES:
            if self._gp_pending:
                self._gp.observe(np.stack(self._gp_pending))
                self._gp_pending.clear()
            gp = self._maybe_refresh(self._gp, ys).fit_y_multi(ys)
            known = (self._classified_mask(flats)
                     if self.mean_only else np.zeros(len(flats), bool))
            if known.any():
                # classified points: means only, zero width — the variance
                # solve is skipped for the whole classified slice
                mu = np.empty((len(xp), ys.shape[1]))
                sig = np.zeros_like(mu)
                fresh = ~known
                if fresh.any():
                    mu[fresh], sig[fresh] = gp.predict_multi(xp[fresh])
                mu[known] = gp.predict_mean_multi(xp[known])
                self.n_mean_only += int(known.sum())
            else:
                mu, sig = gp.predict_multi(xp)
        else:
            known = np.zeros(len(flats), bool)
            gp = GP(lengthscale=self._ls).fit_x(self.observed_points())
            gp = self._maybe_refresh(gp, ys)
            mus, sigs = [], []
            for j in range(ys.shape[1]):
                m, s = gp.fit_y(ys[:, j]).predict(xp)
                mus.append(m)
                sigs.append(s)
            mu = np.stack(mus, 1)
            sig = np.stack(sigs, 1)
        lcb = mu - self.beta * sig
        maybe = pal_maybe_pareto(ys, lcb)
        if self.mean_only and self.gp_mode in STREAM_GP_MODES:
            # a full-posterior LCB box found dominated is a permanent
            # classification (the ε-PAL discard step)
            for f in flats[~maybe & ~known]:
                self._ruled_out.add(int(f))
        width = np.sum(sig, axis=1) * np.where(maybe, 1.0, 0.05)
        for i in np.argsort(-width):
            if len(out) >= n:
                break
            f = int(flats[i])
            if f in self._seen:
                continue
            self._seen.add(f)
            out.append(self.space.index_decode(idx[i]))
        while len(out) < n:
            out.append(self.space.sample(self.rng))
        return out
