"""Serving engine: batched prefill + greedy decode (port of ``repro/serve/engine.py``).

Greedy sampling matches the paper's experiments ("we used greedy sampling for
token generation so that all inferences generate the same output"), so the
generation workloads explored by JExplore are deterministic.  The JAX
engine's on-device ``lax.scan`` decode loop is a Python loop here, over a
(B,) position tensor advanced in place: on the card, a CUDA graph's replays.

A vision batch carries ``image_embeds`` beside its ``tokens``, and the
prompt counts the image tokens.  An audio batch has frame embeddings and no
tokens; the reference's ``generate`` reads ``batch["tokens"]`` and fails
with a ``KeyError`` there, and this engine refuses it with a ``ValueError``
before prefilling rather than invent a semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class GenerationResult:
    tokens: Any                  # (B, n_gen) np/int32
    n_prompt: int
    n_generated: int


def pad_caches(caches, cur_len: int, max_len: int):
    """Grow the attention K/V of prefill caches (seq axis cur_len) to max_len
    slots, zero-filled.  A Mamba layer's ``state``/``conv`` have no seq axis
    and stay as prefill returned them."""
    if max_len < cur_len:
        raise ValueError(f"a {cur_len}-position prompt does not fit a {max_len}-slot cache")
    return [{name: F.pad(c, (0, 0, 0, 0, 0, max_len - cur_len)) if name in ("k", "v") else c
             for name, c in layer.items()}
            for layer in caches]


class Engine:
    def __init__(self, model, max_len: int):
        self.model = model
        self.max_len = max_len

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any], n_tokens: int) -> GenerationResult:
        """Greedy-generate n_tokens continuations for the whole batch."""
        cfg = self.model.cfg
        if "tokens" not in batch:
            raise ValueError(
                f"{cfg.name}: Engine.generate continues a prompt of token ids; this "
                f"{cfg.frontend or 'text'} batch has none (keys {sorted(batch)}), and the "
                "reference's Engine has no generation for frame-embedding prompts either")
        prompt_len = (batch["tokens"].shape[1]
                      + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0))
        logits, caches = self.model.prefill(batch)
        caches = pad_caches(caches, prompt_len, self.max_len)
        tok = torch.argmax(logits, dim=-1)[:, None]
        pos = torch.full((tok.shape[0],), prompt_len, dtype=torch.int32, device=self.model.device)
        toks = []
        for _ in range(n_tokens - 1):
            toks.append(tok[:, 0])
            logits, caches = self.model.decode_step(tok, caches, pos)
            tok = torch.argmax(logits, dim=-1)[:, None]
            pos.add_(1)
        toks.append(tok[:, 0])
        out = torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()
        return GenerationResult(tokens=np.asarray(out), n_prompt=prompt_len,
                                n_generated=n_tokens)
