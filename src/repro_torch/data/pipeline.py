"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``).

A seeded Zipf-ish token stream (long-tailed like natural text) packed into
fixed-length training examples with next-token labels.  Deterministic per
(seed, step): resuming from a checkpoint at step N reproduces exactly the
batches an uninterrupted run would have seen, which is what makes
checkpoint/restart bit-exact end-to-end.  The draws are the reference's,
call for call, so a batch here is bit-identical to the reference's for the
same (seed, step), frontend batches included.

Frontend-stub batches (vision/audio) synthesise the precomputed embeddings
the vision and audio archs take in place of a real frontend.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0


class SyntheticLM:
    """Stateless: batch(step) is a pure function of (cfg, arch, step)."""

    def __init__(self, arch: ArchConfig, cfg: DataConfig):
        self.arch = arch
        self.cfg = cfg
        # Zipf over the vocab, renormalised (heavy head like natural text)
        v = arch.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()

    def batch(self, step: int) -> Dict[str, Any]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))
        b, s = self.cfg.batch, self.cfg.seq_len
        toks = rng.choice(self.arch.vocab_size, size=(b, s + 1), p=self._p)
        toks = toks.astype(np.int32)
        out: Dict[str, Any] = {"labels": toks[:, 1:]}
        if self.arch.frontend == "vision":
            f = self.arch.n_frontend_tokens
            out["tokens"] = toks[:, : s - f]
            out["image_embeds"] = rng.standard_normal(
                (b, f, self.arch.d_model), dtype=np.float32)
        elif self.arch.frontend == "audio":
            out["frame_embeds"] = rng.standard_normal(
                (b, s, self.arch.d_model), dtype=np.float32)
        else:
            out["tokens"] = toks[:, :s]
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: Dict[str, Any], device, policy=None) -> Dict[str, Any]:
    """Every array of ``batch`` as a tensor on ``device`` (token ids and labels
    as int64, embeddings as they are); the counterpart of the reference's
    ``device_put_batch``.  With a sharding policy each becomes a DTensor
    placed by ``batch_spec`` (every rank makes the same batch from the same
    (seed, step) and keeps its rows)."""
    import torch

    out = {}
    for key, a in batch.items():
        t = torch.from_numpy(np.require(a, requirements="C"))
        if not t.is_floating_point():
            t = t.long()
        out[key] = t.to(device, non_blocking=True)
    return out if policy is None else policy.batch_shardings(out)
