"""The design space's hardware model: roofline constants, DVFS-style ladders, power.

A copy of ``repro/roofline/hw.py`` with the reference's constants: the
modeled board of the explore loop is the reference's TPU v5e slice, so
the port's metrics stay bit-identical to the reference's.  A profile of
the H100 itself is queued in ROADMAP (slice 2b follow-ups).

The Jetson-knob analogy:
  clock_scale — GPU-frequency ladder (11 steps, like Orin's 306 MHz–1.3 GHz)
  hbm_scale   — EMC-frequency ladder (4 steps; the lowest step mirrors Orin's
                204 MHz/3.2 GHz ≈ 1/16 ratio, which produces the paper's
                detached low-EMC cluster)
  ici_scale   — interconnect ladder (no Jetson analogue; TPU-specific)

Power model (documented, *modeled* constants, not measurements):
  P_chip = IDLE_W
         + COMPUTE_W * clock_scale^2.5 * compute_utilisation
         + HBM_W     * hbm_scale       * memory_utilisation
The 2.5 exponent approximates dynamic power ∝ f·V² with V roughly ∝ √f.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# -- TPU v5e per-chip peaks (assignment-specified constants) -----------------
PEAK_FLOPS_BF16 = 197e12       # FLOP/s
PEAK_FLOPS_FP32 = PEAK_FLOPS_BF16 / 4
HBM_BW = 819e9                 # B/s
ICI_BW_PER_LINK = 50e9         # B/s per link (formula uses chips × link_bw)

# -- modeled power envelope ---------------------------------------------------
IDLE_W = 75.0
COMPUTE_W = 110.0
HBM_W = 30.0

CLOCK_LADDER = tuple(round(0.5 + 0.05 * i, 2) for i in range(11))  # 0.5 … 1.0
HBM_LADDER = (1.0 / 16.0, 1.0 / 3.0, 2.0 / 3.0, 1.0)               # EMC analogue
ICI_LADDER = (0.25, 0.5, 0.75, 1.0)


@dataclasses.dataclass(frozen=True)
class HwModel:
    n_chips: int
    clock_scale: float = 1.0
    hbm_scale: float = 1.0
    ici_scale: float = 1.0
    dtype: str = "bfloat16"

    @property
    def peak_flops(self) -> float:
        base = PEAK_FLOPS_FP32 if self.dtype == "float32" else PEAK_FLOPS_BF16
        return base * self.clock_scale

    @property
    def hbm_bw(self) -> float:
        return HBM_BW * self.hbm_scale

    @property
    def ici_bw(self) -> float:
        return ICI_BW_PER_LINK * self.ici_scale

    # -- roofline terms (global quantities in, seconds out) -------------------
    def roofline_terms(self, flops: float, hbm_bytes: float,
                       collective_bytes: float) -> dict:
        t_comp = flops / (self.n_chips * self.peak_flops)
        t_mem = hbm_bytes / (self.n_chips * self.hbm_bw)
        t_coll = collective_bytes / (self.n_chips * self.ici_bw)
        terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
        terms["dominant"] = max(terms, key=lambda k: terms[k])
        # optimistic overlapped execution: bound by the slowest resource
        terms["step_time_s"] = max(t_comp, t_mem, t_coll)
        return terms

    def roofline_terms_batch(self, flops, hbm_bytes, collective_bytes) -> Dict[str, np.ndarray]:
        """Vectorized :meth:`roofline_terms` over ``(N,)`` arrays of traffic."""
        return _roofline_terms_vec(self.n_chips, self.peak_flops, self.hbm_bw,
                                   self.ici_bw, flops, hbm_bytes,
                                   collective_bytes)

    # -- power ---------------------------------------------------------------
    def power_w(self, flops: float, hbm_bytes: float, step_time_s: float) -> float:
        """Average per-chip power over one step."""
        if step_time_s <= 0:
            return IDLE_W
        util_c = flops / (self.n_chips * self.peak_flops) / step_time_s
        util_m = hbm_bytes / (self.n_chips * self.hbm_bw) / step_time_s
        util_c, util_m = min(util_c, 1.0), min(util_m, 1.0)
        return (IDLE_W
                + COMPUTE_W * (self.clock_scale ** 2.5) * util_c
                + HBM_W * self.hbm_scale * util_m)


def _clock_pow_2_5(clock_scale: np.ndarray) -> np.ndarray:
    """``clock_scale ** 2.5`` elementwise, via *Python* pow on unique values.

    ``np.power`` and CPython's float pow round the last ulp differently; the
    batched path must be bit-identical to the scalar path, and the clock
    ladder has ≤ 11 distinct values, so mapping through Python pow is both
    exact and cheap.
    """
    uniq, inv = np.unique(clock_scale, return_inverse=True)
    return np.asarray([float(c) ** 2.5 for c in uniq], np.float64)[inv]


def _roofline_terms_vec(n_chips, peak_flops, hbm_bw, ici_bw,
                        flops, hbm_bytes, collective_bytes) -> Dict[str, np.ndarray]:
    """Shared vectorized roofline core; every input broadcasts to ``(N,)``.

    Mirrors ``HwModel.roofline_terms`` operation-for-operation so results are
    bit-identical to the scalar sweep (IEEE basic ops are exactly rounded, so
    elementwise numpy float64 == Python float arithmetic).
    """
    t_comp = np.asarray(flops, np.float64) / (n_chips * peak_flops)
    t_mem = np.asarray(hbm_bytes, np.float64) / (n_chips * hbm_bw)
    t_coll = np.asarray(collective_bytes, np.float64) / (n_chips * ici_bw)
    t_comp, t_mem, t_coll = np.broadcast_arrays(t_comp, t_mem, t_coll)
    stacked = np.stack([t_comp, t_mem, t_coll])
    # argmax ties resolve to the first index — same order as the scalar dict
    names = np.asarray(["compute_s", "memory_s", "collective_s"])
    return {
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "dominant": names[np.argmax(stacked, axis=0)],
        "step_time_s": np.max(stacked, axis=0),
    }


class HwModelBatch:
    """Vectorized view over N hw-knob variants sharing ``n_chips``/``dtype``.

    This is the measurement half of the batched fast path: one compiled
    artifact (fixed sw knobs → fixed flops/bytes/wire-bytes) swept across the
    hardware ladders as ``(N,)`` numpy arrays instead of N scalar
    ``HwModel`` round-trips.  All outputs are bit-identical to the scalar
    :class:`HwModel` methods (see ``_clock_pow_2_5`` for the one libm
    subtlety).
    """

    def __init__(self, n_chips: int, clock_scale: np.ndarray,
                 hbm_scale: np.ndarray, ici_scale: np.ndarray,
                 dtype: str = "bfloat16"):
        self.n_chips = n_chips
        self.clock_scale = np.asarray(clock_scale, np.float64)
        self.hbm_scale = np.asarray(hbm_scale, np.float64)
        self.ici_scale = np.asarray(ici_scale, np.float64)
        self.dtype = dtype
        assert self.clock_scale.shape == self.hbm_scale.shape == self.ici_scale.shape
        self._cpow: Optional[np.ndarray] = None
        # JTime and JPower both sweep the same (prefill, decode) artifacts
        # over this batch; memoising by the scalar traffic triple halves the
        # numpy work without changing any returned value
        self._terms_memo: Dict[Tuple[float, float, float],
                               Dict[str, np.ndarray]] = {}

    @classmethod
    def from_models(cls, models: Sequence[HwModel]) -> "HwModelBatch":
        assert models, "empty batch"
        n_chips, dtype = models[0].n_chips, models[0].dtype
        assert all(m.n_chips == n_chips and m.dtype == dtype for m in models), \
            "a batch shares n_chips and dtype (both are sw-fingerprint fields)"
        return cls(n_chips,
                   np.asarray([m.clock_scale for m in models], np.float64),
                   np.asarray([m.hbm_scale for m in models], np.float64),
                   np.asarray([m.ici_scale for m in models], np.float64),
                   dtype)

    def __len__(self) -> int:
        return self.clock_scale.shape[0]

    def iter_models(self):
        """Scalar ``HwModel`` per variant — the un-vectorized fallback view."""
        for c, h, i in zip(self.clock_scale, self.hbm_scale, self.ici_scale):
            yield HwModel(n_chips=self.n_chips, clock_scale=float(c),
                          hbm_scale=float(h), ici_scale=float(i),
                          dtype=self.dtype)

    @property
    def peak_flops(self) -> np.ndarray:
        base = PEAK_FLOPS_FP32 if self.dtype == "float32" else PEAK_FLOPS_BF16
        return base * self.clock_scale

    @property
    def hbm_bw(self) -> np.ndarray:
        return HBM_BW * self.hbm_scale

    @property
    def ici_bw(self) -> np.ndarray:
        return ICI_BW_PER_LINK * self.ici_scale

    def roofline_terms_batch(self, flops, hbm_bytes, collective_bytes) -> Dict[str, np.ndarray]:
        """Per-variant roofline terms; traffic args are scalars or ``(N,)``."""
        key = None
        if (isinstance(flops, float) and isinstance(hbm_bytes, float)
                and isinstance(collective_bytes, float)):
            key = (flops, hbm_bytes, collective_bytes)
            hit = self._terms_memo.get(key)
            if hit is not None:
                return hit
        terms = _roofline_terms_vec(self.n_chips, self.peak_flops, self.hbm_bw,
                                    self.ici_bw, flops, hbm_bytes,
                                    collective_bytes)
        if key is not None:
            self._terms_memo[key] = terms
        return terms

    def power_w_batch(self, flops, hbm_bytes, step_time_s) -> np.ndarray:
        """Vectorized ``HwModel.power_w`` over ``(N,)`` step times."""
        if self._cpow is None:
            self._cpow = _clock_pow_2_5(self.clock_scale)
        t = np.asarray(step_time_s, np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            util_c = np.asarray(flops, np.float64) / (self.n_chips * self.peak_flops) / t
            util_m = np.asarray(hbm_bytes, np.float64) / (self.n_chips * self.hbm_bw) / t
        util_c = np.minimum(util_c, 1.0)
        util_m = np.minimum(util_m, 1.0)
        p = (IDLE_W
             + COMPUTE_W * self._cpow * util_c
             + HBM_W * self.hbm_scale * util_m)
        return np.where(t <= 0, IDLE_W, p)
