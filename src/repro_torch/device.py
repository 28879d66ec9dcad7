"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device to run on: the CUDA card unless the caller names another.

    With ``device=None`` this returns ``cuda`` and raises when PyTorch sees no
    CUDA device; it never falls back to the CPU.  Callers that want the CPU
    (the tests) pass ``device="cpu"``.
    """
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to PyTorch; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
