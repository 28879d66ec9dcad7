"""The cost record of one build, and its roofline report.

Port of ``repro/roofline/analysis.py``: ``Artifact`` and
``roofline_report`` are copies.  The reference fills an Artifact from a
compiled XLA executable (``summarize``: ``cost_analysis``,
``memory_analysis`` and a parse of the optimized HLO's collectives).  The
port has no HLO; ``repro_torch.launch.build`` counts the same fields on the
``meta`` device instead (its docstring states how).

Collective wire bytes use the standard ring-algorithm costs per device,
with g the group size:

  all-gather        out_bytes · (g-1)/g         (out = gathered result)
  all-reduce        2 · bytes · (g-1)/g         (reduce-scatter + all-gather)
  reduce-scatter    out_bytes · (g-1)            (out = scattered shard)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class Artifact:
    """Everything JMeasure needs, extracted once per build."""
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collectives: Dict[str, float]
    arg_bytes: int
    temp_bytes: int
    output_bytes: int
    n_devices: int
    hlo_ops: Optional[Dict[str, int]] = None
    # analytic fusion-aware HBM traffic (roofline/traffic.py); the raw
    # 'bytes accessed' above overstates HBM traffic (no fusion modeling)
    hbm_est_per_device: Optional[float] = None

    @property
    def global_flops(self) -> float:
        return self.flops_per_device * self.n_devices

    @property
    def effective_bytes_per_device(self) -> float:
        return (self.hbm_est_per_device if self.hbm_est_per_device is not None
                else self.bytes_per_device)

    @property
    def peak_memory_per_device(self) -> int:
        return self.arg_bytes + self.temp_bytes + self.output_bytes


def roofline_report(art: Artifact, hw) -> dict:
    """Three-term roofline + dominant bottleneck for one artifact."""
    terms = hw.roofline_terms(art.global_flops,
                              art.bytes_per_device * art.n_devices,
                              art.wire_bytes_per_device * art.n_devices)
    terms.update(
        flops_per_device=art.flops_per_device,
        bytes_per_device=art.bytes_per_device,
        wire_bytes_per_device=art.wire_bytes_per_device,
        peak_mem_per_device=art.peak_memory_per_device,
    )
    return terms
