"""DeepSeek-MoE 16B — fine-grained MoE, 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,          # dense FFN width used by the first_k_dense layer
    vocab_size=102400,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,       # fine-grained expert hidden
    first_k_dense=1,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
))
