"""LLaVA-v1.5 7B — the paper's own second workload (Fig. 4): Vicuna-7B
backbone (llama2-7b arch) + CLIP ViT-L/14-336 frontend (STUB, 576 patch
tokens). [NeurIPS 2023 Visual Instruction Tuning]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="llava-v1.5-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    frontend="vision",
    n_frontend_tokens=576,
    pattern=(LayerSpec(),),
))
