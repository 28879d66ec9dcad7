"""Design-space definition — the Table-I analogue for TPU pods.

A ``DesignSpace`` is an ordered list of discrete ``Knob``s.  Knobs are either
``hw`` (hardware-ladder values that only re-evaluate the analytic measurement
model — the Jetson frequency knobs) or ``sw`` (values that change the lowered
HLO and force a re-compile — there is no Jetson analogue because Jetson doesn't
recompile, but on a compiler-scheduled architecture these ARE the design
space).  JClient caches compiled artifacts keyed by the sw subset.

Knob applicability can be conditioned on the architecture/shape (e.g. the
attention-tiling knobs are masked out for the attention-free mamba2 arch, per
DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.roofline import hw as hwmod

KIND_HW = "hw"
KIND_SW = "sw"


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    values: Tuple[Any, ...]
    kind: str = KIND_HW

    def __post_init__(self):
        assert self.kind in (KIND_HW, KIND_SW)
        assert len(self.values) >= 1


class DesignSpace:
    def __init__(self, knobs: Sequence[Knob]):
        self.knobs: List[Knob] = list(knobs)
        self._by_name = {k.name: k for k in self.knobs}
        assert len(self._by_name) == len(self.knobs), "duplicate knob names"

    # -- basic ----------------------------------------------------------------
    def __iter__(self):
        return iter(self.knobs)

    def __getitem__(self, name: str) -> Knob:
        return self._by_name[name]

    def names(self) -> List[str]:
        return [k.name for k in self.knobs]

    def size(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.values)
        return n

    def default(self) -> Dict[str, Any]:
        return {k.name: k.values[-1] for k in self.knobs}

    # -- sampling / encoding ----------------------------------------------------
    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        return {k.name: k.values[rng.integers(len(k.values))] for k in self.knobs}

    def sample_index_batch(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``(n, K)`` int64 matrix of value indices — a whole candidate pool
        in K vectorized rng calls instead of n·K scalar ones."""
        if not self.knobs:
            return np.zeros((n, 0), np.int64)
        return np.stack([rng.integers(len(k.values), size=n)
                         for k in self.knobs], axis=1)

    def sample_batch(self, rng: np.random.Generator, n: int) -> List[Dict]:
        return self.index_decode_batch(self.sample_index_batch(rng, n))

    def index_decode_batch(self, idx: np.ndarray) -> List[Dict]:
        names = [k.name for k in self.knobs]
        values = [k.values for k in self.knobs]
        return [{nm: vs[int(i)] for nm, vs, i in zip(names, values, row)}
                for row in np.asarray(idx)]

    def index_encode_batch(self, configs: Sequence[Dict[str, Any]]) -> np.ndarray:
        """``(n, K)`` int64 value-index matrix for a list of configs."""
        luts = [{v: i for i, v in enumerate(k.values)} for k in self.knobs]
        return np.asarray([[lut[c[k.name]]
                            for lut, k in zip(luts, self.knobs)]
                           for c in configs], np.int64).reshape(len(configs),
                                                                len(self.knobs))

    def encode_index_batch(self, idx: np.ndarray) -> np.ndarray:
        """Normalise an ``(n, K)`` index matrix to [0, 1] coordinates (the
        batch analogue of ``encode``, one broadcast divide)."""
        scale = np.asarray([max(len(k.values) - 1, 1) for k in self.knobs],
                           np.float64)
        return np.asarray(idx, np.float64) / scale

    def encode_batch(self, configs: Sequence[Dict[str, Any]]) -> np.ndarray:
        """``(n, K)`` search coordinates for a list of configs in one shot."""
        return self.encode_index_batch(self.index_encode_batch(configs))

    def encode(self, config: Dict[str, Any]) -> np.ndarray:
        """Ordinal indices normalised to [0, 1] — search-algorithm coordinates."""
        out = []
        for k in self.knobs:
            i = k.values.index(config[k.name])
            out.append(i / max(len(k.values) - 1, 1))
        return np.asarray(out, dtype=np.float64)

    def decode(self, vec: np.ndarray) -> Dict[str, Any]:
        cfg = {}
        for k, x in zip(self.knobs, vec):
            i = int(round(float(np.clip(x, 0.0, 1.0)) * (len(k.values) - 1)))
            cfg[k.name] = k.values[i]
        return cfg

    def index_encode(self, config: Dict[str, Any]) -> np.ndarray:
        return np.asarray([k.values.index(config[k.name]) for k in self.knobs], np.int64)

    def index_decode(self, idx: np.ndarray) -> Dict[str, Any]:
        return {k.name: k.values[int(i) % len(k.values)] for k, i in zip(self.knobs, idx)}

    def mutate(self, config: Dict[str, Any], rng: np.random.Generator,
               p: float = 0.25) -> Dict[str, Any]:
        """±1-step ordinal mutation (frequency ladders are ordered)."""
        out = dict(config)
        for k in self.knobs:
            if len(k.values) > 1 and rng.random() < p:
                i = k.values.index(out[k.name])
                step = int(rng.choice([-1, 1]))
                out[k.name] = k.values[int(np.clip(i + step, 0, len(k.values) - 1))]
        return out


# ---------------------------------------------------------------------------
# The production TPU-pod space (Table-I analogue)
# ---------------------------------------------------------------------------


def tpu_pod_space(arch=None, shape=None, n_chips: int = 256,
                  include_sw: bool = True) -> DesignSpace:
    """Build the default space, masking knobs inapplicable to (arch, shape)."""
    knobs: List[Knob] = [
        Knob("clock_scale", hwmod.CLOCK_LADDER, KIND_HW),
        Knob("hbm_scale", hwmod.HBM_LADDER, KIND_HW),
        Knob("ici_scale", hwmod.ICI_LADDER, KIND_HW),
    ]
    if not include_sw:
        return DesignSpace(knobs)

    is_train = shape is None or shape.kind == "train"
    has_attn = arch is None or arch.n_heads > 0
    has_ssm = arch is None or arch.ssm_state > 0
    batch = None if shape is None else shape.global_batch

    # mesh factorisation: dp · tp = n_chips (the "# cores per cluster" analogue)
    dps = [d for d in (4, 8, 16, 32, 64) if n_chips % d == 0
           and (batch is None or batch % d == 0)]
    if not dps:
        dps = [1]
    knobs.append(Knob("dp_degree", tuple(dps), KIND_SW))
    knobs.append(Knob("dtype", ("bfloat16",), KIND_SW))
    knobs.append(Knob("fsdp", (False, True), KIND_SW))
    if is_train:
        knobs += [
            Knob("microbatch", (1, 2, 4), KIND_SW),
            Knob("remat", ("none", "selective", "full"), KIND_SW),
            Knob("sp", (False, True), KIND_SW),
            Knob("grad_rs", (False, True), KIND_SW),
            Knob("loss_chunks", (1, 8), KIND_SW),
        ]
    if has_attn:
        knobs += [
            Knob("attn_block_q", (128, 256, 512), KIND_SW),
            Knob("attn_block_kv", (128, 256, 512), KIND_SW),
        ]
    if has_ssm:
        knobs.append(Knob("ssd_chunk", (128, 256, 512), KIND_SW))
    return DesignSpace(knobs)
