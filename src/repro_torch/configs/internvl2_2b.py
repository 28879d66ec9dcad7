"""InternVL2 2B — InternViT frontend (STUB) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (n_frontend_tokens of them) that are concatenated
ahead of the text embeddings."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    n_frontend_tokens=576,
    pattern=(LayerSpec(),),
))
