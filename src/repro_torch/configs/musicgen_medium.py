"""MusicGen medium — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings; the backbone is the transformer below."""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
    pattern=(LayerSpec(),),
))
