"""CUDA-kernel incremental GP — the ``gp_mode="cuda"`` tell and ask path.

Port of ``repro/core/search/gp_pallas.py``.  ``CudaIncrementalGP``
subclasses ``TorchIncrementalGP`` and replaces exactly the two device calls
that dominate past n≈10⁴ with the hand-written kernels of
``repro_torch.kernels.gp_ops``:

* ``_append_active`` → ``gp_ops.gp_append`` — the rank-append Cholesky's
  triangular applications (K1a, K1b) run only over active-row tiles (the
  live count is a host integer passed by value), O(n·block) per tell
  instead of the full-capacity O(capacity²) products of the torch tier.
* ``score_ehvi`` → ``gp_ops.gp_fused_ehvi`` — cross-covariance, posterior
  mean, denormalisation and the EHVI staircase sweep in one kernel (K2);
  the (P, n) kernel matrix never reaches device memory.

Everything else — buffers, archive, inducing thinning/re-thinning, fits,
predicts, the degenerate-append refactor fallback — is inherited.  On a CPU
device the wrappers take the kernels' plain versions (the tests); on the
card they launch the kernels or raise.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.search.gp_torch import TorchIncrementalGP, _ils
from repro_torch.kernels import gp_ops


class CudaIncrementalGP(TorchIncrementalGP):
    """Drop-in for ``TorchIncrementalGP`` with CUDA tell/ask hot loops.

    ``block`` and ``pool_block`` are the reference's tile knobs, accepted
    for parity and not used: the kernels choose their own tiles, because
    the reference's 256 × 256 float64 tiles (512 KB) do not fit a Hopper
    block's 227 KB of shared memory.  ``n_cuda_appends``/``n_cuda_scores``
    count the calls that went through the kernels.
    """

    kind = "cuda"

    def __init__(self, lengthscale=0.3, noise: float = 1e-3,
                 signal: float = 1.0, inducing_threshold=None,
                 inducing_overflow: float = 1.25, block: int = 256,
                 pool_block: int = 256, device=None):
        super().__init__(lengthscale=lengthscale, noise=noise, signal=signal,
                         inducing_threshold=inducing_threshold,
                         inducing_overflow=inducing_overflow, device=device)
        self.n_cuda_appends = 0
        self.n_cuda_scores = 0

    # -- kernel lengthscale plumbing ------------------------------------------
    def _ls_args(self):
        """(ls², reciprocal-ARD row or None) — the same two kernel forms as
        ``gp_torch._kern``: a scalar ls divides distances by ls²; an ARD
        vector pre-scales the inputs."""
        ils = _ils(self.ls, self.device)
        if ils is None:
            return float(self.ls) * float(self.ls), None
        return 1.0, ils

    # -- overridden hot loops -------------------------------------------------
    def _append_active(self, xa: np.ndarray, idx: np.ndarray) -> None:
        _, xpad = self._padded_block(xa)
        ls2, ils = self._ls_args()
        ok = gp_ops.gp_append(self._xb, self._lb, self._lib, self._n, len(xa),
                              xpad, ils, self.noise, ls2=ls2, signal=self.signal)
        self.n_cuda_appends += 1
        self._appended(len(xa), idx, ok)

    def score_ehvi(self, xs: np.ndarray, front_y: np.ndarray,
                   ref: np.ndarray) -> np.ndarray:
        xs, fpad, ref = self._front(xs, front_y, ref)
        if xs is None:
            return np.zeros(0)
        if fpad is None:
            # no valid front: the inherited mean path (cold branch, first
            # iterations only)
            return self._rectangle_ehvi(xs, ref)
        # the (3, S) staircase is built on the host: lows/ups/levels rows,
        # sentinel-padded segments are zero-width so the sum is exact
        x, y = fpad[:, 0], fpad[:, 1]
        stair = np.stack([
            np.concatenate([[-np.inf], x]),
            np.concatenate([x, ref[0:1]]),
            np.concatenate([ref[1:2], y]),
        ])
        ymd = np.stack([np.asarray(self._ym_m, float),
                        np.asarray(self._ys_m, float)])
        xq, M = self._pad_pool(xs)
        ls2, ils = self._ls_args()
        s = gp_ops.gp_fused_ehvi(self._xb, self._alpha_m, self._n, xq,
                                 self._dev(stair), self._dev(ymd), ils,
                                 ls2=ls2, signal=self.signal)
        self.n_cuda_scores += 1
        return s.cpu().numpy()[:M]

    def stats(self) -> dict:
        out = super().stats()
        out["cuda_appends"] = self.n_cuda_appends
        out["cuda_scores"] = self.n_cuda_scores
        return out
