from repro_torch.configs.base import (
    ArchConfig,
    LayerSpec,
    ShapeConfig,
    SHAPES,
    get_arch,
    list_archs,
    reduced,
    shape_applicable,
)

ASSIGNED_ARCHS = [
    "deepseek-moe-16b",
    "llama4-maverick-400b-a17b",
    "glm4-9b",
    "tinyllama-1.1b",
    "gemma3-27b",
    "yi-9b",
    "jamba-v0.1-52b",
    "musicgen-medium",
    "internvl2-2b",
    "mamba2-780m",
]
PAPER_ARCHS = ["llama2-7b", "llava-v1.5-7b"]
