"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE 16e top-2 every other
layer. [arXiv:2403.19887; hf]

Hardware adaptation note (DESIGN.md §2): Jamba uses Mamba-1 selective scan on
GPU; we implement the state-space mixer with the Mamba-2 SSD chunked matmul
formulation because it maps onto the TPU MXU (dense chunk matmuls) instead of
a sequential elementwise scan."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

_pat = []
for i in range(8):
    mixer = "attn" if i == 4 else "mamba"       # attention every 8th layer
    ffn = "moe" if i % 2 == 1 else "dense"      # MoE every other layer
    _pat.append(LayerSpec(mixer=mixer, ffn=ffn))

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    pattern=tuple(_pat),
    subquadratic=True,
))
