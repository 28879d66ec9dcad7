"""Architecture & workload-shape definitions (a copy of ``repro.configs.base``).

``ArchConfig`` is the single source of truth a model is built from.  Every
assigned architecture (plus the paper's own two workloads) provides one
``ArchConfig`` in its ``src/repro_torch/configs/<id>.py`` module and
registers it.  The data is identical to the JAX package's; the copy exists
so that the PyTorch port imports nothing of that package.

Layer heterogeneity (gemma3's 5:1 local:global, jamba's 1:7 attn:mamba with
every-other-layer MoE) is expressed with a repeating ``pattern`` of
``LayerSpec``s.  The JAX stack scans over ``len(layers)//len(pattern)``
pattern groups and unrolls the remainder; the port keeps the same section
order but holds its layers in an ``nn.ModuleList``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

MIXER_ATTN = "attn"            # full (causal) self attention
MIXER_ATTN_LOCAL = "attn_local"  # sliding-window self attention
MIXER_MAMBA = "mamba"          # Mamba-2 SSD block

FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"              # e.g. mamba2 blocks carry no separate FFN


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = MIXER_ATTN
    ffn: str = FFN_DENSE

    def __post_init__(self):
        assert self.mixer in (MIXER_ATTN, MIXER_ATTN_LOCAL, MIXER_MAMBA), self.mixer
        assert self.ffn in (FFN_DENSE, FFN_MOE, FFN_NONE), self.ffn


# ---------------------------------------------------------------------------
# ArchConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    # -- attention ----------------------------------------------------------
    n_heads: int = 0                  # 0 for attention-free archs
    n_kv_heads: int = 0
    head_dim: int = 0                 # explicit; may differ from d_model//n_heads
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # window size for MIXER_ATTN_LOCAL layers
    # -- dense FFN -----------------------------------------------------------
    d_ff: int = 0
    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden (fine-grained MoE)
    capacity_factor: float = 1.25
    first_k_dense: int = 0            # leading layers that use dense FFN instead
    # -- Mamba-2 SSD -----------------------------------------------------------
    ssm_state: int = 0                # N
    ssm_head_dim: int = 64            # P
    ssm_expand: int = 2               # d_inner = expand * d_model
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # -- layer pattern ----------------------------------------------------------
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # -- modality frontend (stub: precomputed embeddings are model inputs) -----
    frontend: Optional[str] = None    # None | "vision" | "audio"
    n_frontend_tokens: int = 0        # e.g. 576 image-patch tokens
    # -- misc -------------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # -- port only (the JAX package has none of these; each default leaves
    # the computation as it is) ---------------------------------------------------
    attn_scale: float = 0.0           # attention softmax scale; 0: d_head ** -0.5
    rope: bool = True                 # False: no rotary embedding (NoPE attention)
    embedding_multiplier: float = 1.0  # token embeddings times this
    residual_multiplier: float = 1.0   # each mixer and FFN output times this, before its add
    logits_scaling: float = 1.0        # logits divided by this
    # Whether the arch has a sub-quadratic long-context path (long_500k runs).
    subquadratic: bool = False

    # -- derived ----------------------------------------------------------------
    @property
    def d_head(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def softmax_scale(self) -> float:
        return self.attn_scale if self.attn_scale else self.d_head ** -0.5

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Expanded per-layer specs of length ``n_layers``.

        ``first_k_dense`` downgrades the MoE FFN of the leading layers to dense
        (DeepSeek-MoE convention).
        """
        reps = -(-self.n_layers // len(self.pattern))
        specs = (self.pattern * reps)[: self.n_layers]
        out = []
        for i, s in enumerate(specs):
            if s.ffn == FFN_MOE and i < self.first_k_dense:
                s = LayerSpec(mixer=s.mixer, ffn=FFN_DENSE)
            out.append(s)
        return tuple(out)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs accounting)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


# ---------------------------------------------------------------------------
# Workload shapes (assigned set — identical for every LM-family arch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason).  long_500k needs a sub-quadratic long-context path."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch: long_500k skipped (per assignment)"
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:  # lazy import of all config modules
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    import importlib

    mods = [
        "deepseek_moe_16b",
        "llama4_maverick_400b_a17b",
        "glm4_9b",
        "tinyllama_1_1b",
        "gemma3_27b",
        "yi_9b",
        "jamba_v0_1_52b",
        "musicgen_medium",
        "internvl2_2b",
        "mamba2_780m",
        "llama2_7b",
        "llava_v1_5_7b",
    ]
    for m in mods:
        importlib.import_module(f"repro_torch.configs.{m}")


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=max(2, len(cfg.pattern)),
        d_model=64,
        vocab_size=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        n_experts=4 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        first_k_dense=min(cfg.first_k_dense, 1),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        sliding_window=8 if cfg.sliding_window else 0,
        n_frontend_tokens=4 if cfg.n_frontend_tokens else 0,
        name=cfg.name + "-reduced",
    )
    base.update(overrides)
    # keep pattern length dividing n_layers where possible
    if base["n_layers"] % len(cfg.pattern):
        base["n_layers"] = len(cfg.pattern) * max(1, base["n_layers"] // len(cfg.pattern))
        base["n_layers"] = max(base["n_layers"], len(cfg.pattern))
    return dataclasses.replace(cfg, **base)
