"""GLM-4 9B — dense GQA (kv=2) + RoPE. [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    pattern=(LayerSpec(),),
))
