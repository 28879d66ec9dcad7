"""Llama-4 Maverick 400B-A17B — MoE 128e top-1 (+1 shared), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Maverick interleaves dense and MoE FFN layers 1:1 (that is what makes the
total 400B rather than ~780B at 48 layers × 128 experts)."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    n_shared_experts=1,
    moe_top_k=1,
    moe_d_ff=8192,
    rope_theta=500_000.0,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),
             LayerSpec(mixer="attn", ffn="moe")),
))
