"""Gemma-3 27B — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

The 5 sliding-window layers per group make long-context decode sub-quadratic
in aggregate; the 1-in-6 global layers are linear-per-token at decode, so
long_500k runs for this arch (noted in DESIGN.md §Arch-applicability)."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_L = LayerSpec(mixer="attn_local")
_G = LayerSpec(mixer="attn")

CONFIG = register(ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    pattern=(_L, _L, _L, _L, _L, _G),
    subquadratic=True,
))
