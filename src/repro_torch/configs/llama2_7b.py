"""Llama-2 7B — the paper's own first workload (Fig. 2). [arXiv:2302.13971]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    pattern=(LayerSpec(),),
))
