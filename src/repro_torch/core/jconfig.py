"""JConfig — configuration management (paper §III).

A copy of ``repro/core/jconfig.py`` over the port's ``BuildFlags``.

Turns a design-point dict into everything the client needs to apply it:
  * ``BuildFlags``  — the HLO-affecting (sw) subset
  * mesh factorisation (dp, tp)
  * ``HwModel``     — the hardware-ladder (hw) subset
  * ``cache_key``   — hashable sw fingerprint; JClient re-uses the compiled
    artifact when only hw knobs changed (the analogue of Jetson re-clocking
    without touching the deployed network).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.space import DesignSpace, KIND_SW
from repro_torch.models.model import BuildFlags
from repro_torch.roofline.hw import HwModel, HwModelBatch


@dataclasses.dataclass(frozen=True)
class TestConfig:
    """One unit of work pushed host → client (Algorithm 1's testConfig)."""
    config_id: int
    arch: str
    shape: str
    knobs: Dict[str, Any]

    def to_wire(self) -> dict:
        return {"config_id": self.config_id, "arch": self.arch,
                "shape": self.shape, "knobs": self.knobs}

    @staticmethod
    def from_wire(d: dict) -> "TestConfig":
        return TestConfig(d["config_id"], d["arch"], d["shape"], d["knobs"])


TestConfig.__test__ = False  # not a pytest class


class JConfig:
    def __init__(self, space: DesignSpace, n_chips: int = 256):
        self.space = space
        self.n_chips = n_chips
        # sorted once: cache_key is on the batched hot path (once per config)
        self._sw_names = tuple(sorted(
            k.name for k in space if k.kind == KIND_SW))

    def build_flags(self, knobs: Dict[str, Any]) -> BuildFlags:
        kw = {}
        for f in ("dtype", "remat", "loss_chunks", "attn_block_q",
                  "attn_block_kv", "sp", "fsdp", "grad_rs"):
            if f in knobs:
                kw[f] = knobs[f]
        return BuildFlags(**kw)

    def mesh_factors(self, knobs: Dict[str, Any]) -> Tuple[int, int]:
        dp = int(knobs.get("dp_degree", 16))
        assert self.n_chips % dp == 0, (dp, self.n_chips)
        return dp, self.n_chips // dp

    def microbatch(self, knobs: Dict[str, Any]) -> int:
        return int(knobs.get("microbatch", 1))

    def ssd_chunk(self, knobs: Dict[str, Any]) -> Optional[int]:
        return knobs.get("ssd_chunk")

    def hw_model(self, knobs: Dict[str, Any]) -> HwModel:
        return HwModel(
            n_chips=self.n_chips,
            clock_scale=float(knobs.get("clock_scale", 1.0)),
            hbm_scale=float(knobs.get("hbm_scale", 1.0)),
            ici_scale=float(knobs.get("ici_scale", 1.0)),
            dtype=str(knobs.get("dtype", "bfloat16")),
        )

    def hw_model_batch(self, knobs_seq: Sequence[Dict[str, Any]]) -> HwModelBatch:
        """Vectorized ``hw_model`` over configs sharing a sw fingerprint.

        ``dtype`` is a sw knob, so within one cache-key group it is uniform —
        the batch takes it from the first member.
        """
        return HwModelBatch(
            self.n_chips,
            np.asarray([float(k.get("clock_scale", 1.0)) for k in knobs_seq]),
            np.asarray([float(k.get("hbm_scale", 1.0)) for k in knobs_seq]),
            np.asarray([float(k.get("ici_scale", 1.0)) for k in knobs_seq]),
            dtype=str(knobs_seq[0].get("dtype", "bfloat16")))

    def cache_key(self, tc: TestConfig) -> Tuple:
        """Fingerprint of everything that changes the compiled artifact."""
        knobs = tc.knobs
        # knob names are unique, so name-sorted pairs == sorted pairs
        sw = tuple((n, knobs[n]) for n in self._sw_names if n in knobs)
        return (tc.arch, tc.shape, sw)

    def identity(self) -> Tuple:
        """Stable fingerprint of this configuration manager itself — the
        design space (names, value sets, kinds) and the chip count.  The
        persistent artifact cache addresses entries by ``(identity(),
        cache_key(tc))``, so artifacts built under a different space or
        fleet shape can never be served by mistake."""
        return ("jconfig-v1", self.n_chips,
                tuple((k.name, k.kind, tuple(repr(v) for v in k.values))
                      for k in self.space))
