"""JMeasure — metric measurement (paper §III).

A copy of ``repro/core/jmeasure.py``: the measures read an ``Artifact``,
which the port's ``launch/build.py`` counts on the ``meta`` device.

Abstract exactly as in the paper so users plug custom measurement functions;
the bundled implementations are the reference's adaptation of JTime /
JPower / JMemory.  On Jetson these read wall-clocks and INA power rails;
here they evaluate the analytic roofline and power model over a build's
Artifact.  Wall-clock or power-rail plugins take the same ABC without
touching JHost/JClient/search code.
"""
from __future__ import annotations

import abc
from typing import Dict

import numpy as np

from repro_torch.roofline.analysis import Artifact
from repro_torch.roofline.hw import HwModel, HwModelBatch


class JMeasure(abc.ABC):
    """One metric.  ``measure`` maps (artifact, hw model, workload meta) → dict.

    ``measure_batch`` is the vectorized form used by the batched fast path:
    one artifact swept over N hardware variants, returning ``(N,)`` arrays
    per metric key.  The base implementation falls back to N scalar
    ``measure`` calls, so custom user measures work in batch mode unchanged;
    the bundled measures override it with one-shot numpy sweeps that are
    bit-identical to the scalar path.
    """

    name: str = "measure"

    @abc.abstractmethod
    def measure(self, art: Artifact, hw: HwModel, meta: Dict) -> Dict[str, float]:
        ...

    def measure_batch(self, art: Artifact, hwb: HwModelBatch,
                      meta: Dict) -> Dict[str, np.ndarray]:
        rows = [self.measure(art, hw, meta) for hw in hwb.iter_models()]
        keys = rows[0].keys() if rows else ()
        return {k: np.asarray([r[k] for r in rows]) for k in keys}


class JTime(JMeasure):
    """Roofline-estimated execution time.

    For generation workloads (the paper's Llama/LLaVA experiments) meta may
    carry ``n_decode_tokens`` and a separate decode artifact; total time is
    t_prefill + n_tokens · t_decode, matching the paper's end-to-end latency.
    """

    name = "time"

    def measure(self, art: Artifact, hw: HwModel, meta: Dict) -> Dict[str, float]:
        terms = hw.roofline_terms(art.global_flops,
                                  art.effective_bytes_per_device * art.n_devices,
                                  art.wire_bytes_per_device * art.n_devices)
        out = {"time_s": terms["step_time_s"],
               "compute_s": terms["compute_s"],
               "memory_s": terms["memory_s"],
               "collective_s": terms["collective_s"],
               "bottleneck": terms["dominant"]}
        dec = meta.get("decode_artifact")
        if dec is not None:
            n_tok = int(meta.get("n_decode_tokens", 0))
            dterms = hw.roofline_terms(dec.global_flops,
                                       dec.effective_bytes_per_device * dec.n_devices,
                                       dec.wire_bytes_per_device * dec.n_devices)
            out["decode_step_s"] = dterms["step_time_s"]
            out["time_s"] = out["time_s"] + n_tok * dterms["step_time_s"]
        n_steps = int(meta.get("n_steps", 0))
        if n_steps:
            out["total_s"] = out["time_s"] * n_steps
        return out

    def measure_batch(self, art: Artifact, hwb: HwModelBatch,
                      meta: Dict) -> Dict[str, np.ndarray]:
        terms = hwb.roofline_terms_batch(
            art.global_flops,
            art.effective_bytes_per_device * art.n_devices,
            art.wire_bytes_per_device * art.n_devices)
        out = {"time_s": terms["step_time_s"],
               "compute_s": terms["compute_s"],
               "memory_s": terms["memory_s"],
               "collective_s": terms["collective_s"],
               "bottleneck": terms["dominant"]}
        dec = meta.get("decode_artifact")
        if dec is not None:
            n_tok = int(meta.get("n_decode_tokens", 0))
            dterms = hwb.roofline_terms_batch(
                dec.global_flops,
                dec.effective_bytes_per_device * dec.n_devices,
                dec.wire_bytes_per_device * dec.n_devices)
            out["decode_step_s"] = dterms["step_time_s"]
            out["time_s"] = out["time_s"] + n_tok * dterms["step_time_s"]
        n_steps = int(meta.get("n_steps", 0))
        if n_steps:
            out["total_s"] = out["time_s"] * n_steps
        return out


class JPower(JMeasure):
    name = "power"

    def measure(self, art: Artifact, hw: HwModel, meta: Dict) -> Dict[str, float]:
        terms = hw.roofline_terms(art.global_flops,
                                  art.effective_bytes_per_device * art.n_devices,
                                  art.wire_bytes_per_device * art.n_devices)
        t = terms["step_time_s"]
        p = hw.power_w(art.global_flops, art.effective_bytes_per_device * art.n_devices, t)
        out = {"power_w": p, "energy_j": p * hw.n_chips * t}
        dec = meta.get("decode_artifact")
        if dec is not None:
            n_tok = int(meta.get("n_decode_tokens", 0))
            dterms = hw.roofline_terms(dec.global_flops,
                                       dec.effective_bytes_per_device * dec.n_devices,
                                       dec.wire_bytes_per_device * dec.n_devices)
            td = dterms["step_time_s"]
            pd = hw.power_w(dec.global_flops,
                            dec.effective_bytes_per_device * dec.n_devices, td)
            tot_t = t + n_tok * td
            tot_e = p * hw.n_chips * t + pd * hw.n_chips * n_tok * td
            out = {"power_w": tot_e / (hw.n_chips * tot_t), "energy_j": tot_e}
        return out

    def measure_batch(self, art: Artifact, hwb: HwModelBatch,
                      meta: Dict) -> Dict[str, np.ndarray]:
        flops = art.global_flops
        hbm = art.effective_bytes_per_device * art.n_devices
        wire = art.wire_bytes_per_device * art.n_devices
        terms = hwb.roofline_terms_batch(flops, hbm, wire)
        t = terms["step_time_s"]
        p = hwb.power_w_batch(flops, hbm, t)
        out = {"power_w": p, "energy_j": p * hwb.n_chips * t}
        dec = meta.get("decode_artifact")
        if dec is not None:
            n_tok = int(meta.get("n_decode_tokens", 0))
            dflops = dec.global_flops
            dhbm = dec.effective_bytes_per_device * dec.n_devices
            dwire = dec.wire_bytes_per_device * dec.n_devices
            dterms = hwb.roofline_terms_batch(dflops, dhbm, dwire)
            td = dterms["step_time_s"]
            pd = hwb.power_w_batch(dflops, dhbm, td)
            tot_t = t + n_tok * td
            tot_e = p * hwb.n_chips * t + pd * hwb.n_chips * n_tok * td
            if np.any(tot_t == 0.0):
                # scalar-path parity: the scalar normalisation raises here
                # (status 'failed') instead of silently emitting NaN
                raise ZeroDivisionError("zero total time in power measurement")
            out = {"power_w": tot_e / (hwb.n_chips * tot_t), "energy_j": tot_e}
        return out


class JMemory(JMeasure):
    name = "memory"

    HBM_BYTES = 16 * 1024 ** 3  # v5e per-chip HBM

    def measure(self, art: Artifact, hw: HwModel, meta: Dict) -> Dict[str, float]:
        peak = art.peak_memory_per_device
        dec = meta.get("decode_artifact")
        if dec is not None:
            peak = max(peak, dec.peak_memory_per_device)
        return {"mem_bytes": float(peak),
                "fits_hbm": float(peak <= self.HBM_BYTES)}

    def measure_batch(self, art: Artifact, hwb: HwModelBatch,
                      meta: Dict) -> Dict[str, np.ndarray]:
        # hw-knob independent: the same artifact footprint for every variant
        peak = art.peak_memory_per_device
        dec = meta.get("decode_artifact")
        if dec is not None:
            peak = max(peak, dec.peak_memory_per_device)
        n = len(hwb)
        return {"mem_bytes": np.full(n, float(peak)),
                "fits_hbm": np.full(n, float(peak <= self.HBM_BYTES))}


DEFAULT_MEASURES = (JTime(), JPower(), JMemory())
