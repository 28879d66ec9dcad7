"""Model facade: prefill / decode built from ArchConfig (port of ``repro/models/model.py``).

``BuildFlags`` holds the reference's fields that the serving path reads,
with the reference's defaults: ``dtype``, ``attn_impl``, the attention tile
knobs and ``ssd_impl``, whose ``"cuda"`` (the kernel K4) is the counterpart
of the reference's ``"pallas"``.  The training, sharding and scan fields
(``remat``, ``loss_chunks``, ``sp``, ``fsdp``, ``grad_rs``, ``unroll``) are
the ones ``core.jconfig.build_flags`` sets; the serving path does not read
them, and ``launch.build`` reads ``sp`` only for its collective formula.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import Embedding, LMHead, RMSNorm

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class BuildFlags:
    dtype: str = "bfloat16"            # activation/param dtype
    attn_impl: str = "xla"             # xla (plain grouped path) | flash (K3)
    attn_block_q: int = 256
    attn_block_kv: int = 256
    ssd_impl: str = "jnp"              # jnp (plain chunked path) | cuda (K4)
    remat: str = "selective"           # none | selective | full (training)
    loss_chunks: int = 1               # chunked vocab-CE (training)
    sp: bool = True                    # sequence-parallel residual stream
    fsdp: bool = True                  # shard params over data axes too
    grad_rs: bool = False              # reduce-scatter grads (training)
    unroll: bool = False               # the reference's scan unrolling

    @property
    def tdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]


class Model(nn.Module):
    """Decoder LM with its weights.

    ``device`` defaults to the CUDA card (``resolve_device``).  With an int
    ``seed`` the weights are drawn from a ``torch.Generator`` on that device
    (normal at std 0.02, norm scales at one); with ``seed=None``, or on the
    ``meta`` device, they are left empty for ``load_state_dict`` (for example
    from ``models.convert.params_from_jax``).
    """

    def __init__(self, cfg: ArchConfig, flags: BuildFlags = BuildFlags(), *,
                 device=None, seed: Optional[int] = 0):
        super().__init__()
        if cfg.frontend:
            raise NotImplementedError(
                f"{cfg.frontend} frontends are not ported yet (ROADMAP Queue 1, "
                "slice 5: vision and audio frontends)")
        dev = resolve_device(device)
        gen = None
        if seed is not None and dev.type != "meta":
            gen = torch.Generator(device=dev).manual_seed(seed)
        dtype = flags.tdtype
        self.cfg = cfg
        self.flags = flags
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dtype, dev, gen)
        self.final_norm = RMSNorm(cfg.d_model, dtype, dev)
        if not cfg.tie_embeddings:
            self.head = LMHead(cfg.d_model, cfg.vocab_size, dtype, dev, gen)
        self.stack = transformer.Stack(cfg, dtype, dev, gen)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _tokens(self, tokens):
        return torch.as_tensor(tokens, device=self.device).long()

    def _logits(self, hidden):
        h = self.final_norm(hidden, self.cfg.norm_eps)
        w = self.embed.table.T if self.cfg.tie_embeddings else self.head.w
        return h @ w

    # -- prefill / decode ----------------------------------------------------------
    def prefill(self, batch):
        """batch {"tokens": (B, S)} -> (last-position logits (B, V), caches)."""
        x = self.embed(self._tokens(batch["tokens"]))
        hidden, caches = self.stack.forward_full(x, self.flags, want_cache=True)
        logits = self._logits(hidden[:, -1:, :])[:, 0]
        return logits, caches

    def decode_step(self, tokens, caches, pos):
        """tokens: (B, 1); pos: int or (B,) tensor.  Returns (logits (B, V), caches).

        The caches are updated in place and returned.
        """
        x = self.embed(self._tokens(tokens))
        hidden, caches = self.stack.forward_decode(x, caches, pos)
        return self._logits(hidden)[:, 0], caches

    def empty_caches(self, batch, seq_len):
        return transformer.empty_caches(self.cfg, batch, seq_len,
                                        self.flags.tdtype, self.device)


# ---------------------------------------------------------------------------
# Analytic parameter counts (for 6ND model-FLOPs accounting)
# ---------------------------------------------------------------------------


def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    d, dh = cfg.d_model, cfg.d_head
    total = 0
    for spec in cfg.layer_specs():
        if spec.mixer in ("attn", "attn_local"):
            total += d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2 + d
        else:
            di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
            total += d * (2 * di + 2 * n + h)          # in_proj
            total += (di + 2 * n) * (cfg.ssm_conv + 1)  # conv w+b
            total += 3 * h + di                        # A_log, D, dt_bias, norm
            total += di * d + d                        # out_proj + norm
        if spec.ffn == "dense":
            f = cfg.d_ff if cfg.d_ff else cfg.moe_d_ff
            total += 3 * d * f + d
        elif spec.ffn == "moe":
            e = cfg.moe_top_k if active_only else cfg.n_experts
            total += 3 * d * cfg.moe_d_ff * e
            total += d * cfg.n_experts                 # router
            total += 3 * d * cfg.moe_d_ff * cfg.n_shared_experts
            total += d
    total += d  # final norm
    if cfg.frontend:
        total += d * d
    # lm head participates in the matmul FLOPs; vocab embedding lookup does not
    total += d * cfg.vocab_size
    return total
