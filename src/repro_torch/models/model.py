"""Model facade: train loss / prefill / decode built from ArchConfig (port of ``repro/models/model.py``).

``BuildFlags`` holds the reference's fields with the reference's defaults:
``dtype``, ``attn_impl``, the attention tile knobs and ``ssd_impl``, whose
``"cuda"`` (the kernel K4) is the counterpart of the reference's
``"pallas"``; ``remat`` and ``loss_chunks``, which the training loss reads;
and the sharding and scan fields (``sp``, ``fsdp``, ``grad_rs``,
``unroll``) that ``core.jconfig.build_flags`` sets: ``launch.build`` reads
``sp``, ``fsdp`` and ``grad_rs`` for its per-device bytes and collective
formulas, ``train.train_step`` reads ``grad_rs``; ``unroll`` has no
counterpart (the layers are a Python loop).

With a sharding policy (``parallel.sharding``) the parameters are DTensors
placed by the reference's rules and the inputs DTensors placed by
``batch_spec``/``cache_spec``; the embedded input and the logits are moved
to the reference's placements (its ``model.py:72-81``), and the layers
constrain the residual stream.  Plain tensors created inside (positions,
masks) count as replicated.

Frontends are stubs, as in the reference: a vision arch takes precomputed
patch embeddings (``image_embeds``, (B, F, d)) that go through one (d, d)
projection ``frontend.proj`` and are put ahead of the text embeddings; an
audio arch takes precomputed frame embeddings (``frame_embeds``, (B, S, d))
through the same projection and has no text tokens.  Decode steps take
token ids for every arch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import Embedding, LMHead, RMSNorm, linear, normal_param
from repro_torch.parallel.sharding import is_distributed, maybe_context

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


class Frontend(nn.Module):
    """The stub frontend's projection ``proj`` (d, d) of precomputed embeddings."""

    def __init__(self, d, dtype, device, generator=None):
        super().__init__()
        self.proj = normal_param((d, d), dtype, device, generator)


class Model(nn.Module):
    """Decoder LM with its weights.

    ``device`` defaults to the CUDA card (``resolve_device``).  With an int
    ``seed`` the weights are drawn from a ``torch.Generator`` on that device
    (normal at std 0.02, norm scales at one); with ``seed=None``, or on the
    ``meta`` device, they are left empty for ``load_state_dict`` (for example
    from ``models.convert.params_from_jax``).  With a ``policy`` the weights
    (equal on every rank: drawn from the same seed) are then distributed by
    it (``ShardingPolicy.param_shardings``, which can also be called later,
    after a ``load_state_dict``).  A policy over a shape-only mesh (the
    builds on ``meta``) distributes nothing; the MoE layers then take its
    dispatch groups (``moe_groups``) on the one device.
    """

    def __init__(self, cfg: ArchConfig, flags: BuildFlags = BuildFlags(), *,
                 device=None, seed: Optional[int] = 0, policy=None):
        super().__init__()
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
        if cfg.frontend:
            self.frontend = Frontend(cfg.d_model, dtype, dev, gen)
        self.stack = transformer.Stack(cfg, dtype, dev, gen)
        self.policy = policy
        if policy is not None and policy.has_devices:
            policy.param_shardings(self)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _tokens(self, tokens):
        return torch.as_tensor(tokens, device=self.device).long()

    def _embeds(self, embeds):
        """Precomputed frontend embeddings, in the model dtype, projected."""
        e = torch.as_tensor(embeds, device=self.device).to(self.flags.tdtype)
        return linear(e, self.frontend.proj)

    # -- embedding of modality inputs -------------------------------------------
    def _embed_inputs(self, batch):
        """batch -> the embedded input (B, S, d): for vision the projected
        ``image_embeds`` then the text embeddings, for audio the projected
        ``frame_embeds``, else the token embeddings."""
        frontend = self.cfg.frontend
        if frontend == "vision":
            x = torch.cat([self._embeds(batch["image_embeds"]),
                           self._token_embeds(batch["tokens"])], dim=1)
        elif frontend == "audio":
            x = self._embeds(batch["frame_embeds"])
        else:
            x = self._token_embeds(batch["tokens"])
        if self.policy is not None:
            x = self.policy.constrain_residual(x)
        return x

    def _token_embeds(self, tokens):
        """The token embeddings; sharded token ids are looked up in the
        vocabulary's shares over model (``ShardingPolicy.vocab_lookup``)."""
        tokens = self._tokens(tokens)
        if not is_distributed(tokens):
            return self.embed(tokens)
        return self.policy.vocab_lookup(self.embed.table, tokens)

    def _logits(self, hidden):
        h = self.final_norm(hidden, self.cfg.norm_eps)
        w = self.embed.table.T if self.cfg.tie_embeddings else self.head.w
        logits = linear(h, w)
        if self.policy is not None:
            logits = self.policy.constrain_logits(logits)
        return logits

    def _ce_sum(self, hidden, labels, mask):
        """Sum over the masked positions of the fp32 cross entropy."""
        logits = self._logits(hidden).float()
        if is_distributed(logits):
            # the vocabulary stays split over model (ShardingPolicy.vocab_ce)
            lz, gold = self.policy.vocab_ce(logits, labels)
        else:
            lz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.sum((lz - gold) * mask)

    # -- train forward -----------------------------------------------------------
    def loss_fn(self, batch):
        """batch: tokens/labels (+ frontend embeds) -> (loss, {"ce", "aux"}).

        Cross entropy in fp32 over the positions whose label is >= 0, plus
        0.01 times the MoE layers' aux loss.  With ``flags.loss_chunks`` = n
        > 1 the sequence is cut into n chunks whose logits are formed one
        at a time (and, with gradients on, recomputed in the backward pass),
        which caps the logits' memory."""
        with maybe_context(self.policy):
            return self._loss(batch)

    def _loss(self, batch):
        x = self._embed_inputs(batch)
        hidden, aux, _ = self.stack.forward_full(x, self.flags, want_cache=False,
                                                 policy=self.policy)
        labels = self._tokens(batch["labels"])
        mask = labels >= 0
        labels = labels.clamp(min=0)
        n = self.flags.loss_chunks
        if n > 1:
            if hidden.shape[1] % n:
                raise ValueError(f"loss_chunks {n} does not divide the sequence "
                                 f"length {hidden.shape[1]}")
            total = hidden.new_zeros((), dtype=torch.float32)
            for h, l, m in zip(hidden.chunk(n, dim=1), labels.chunk(n, dim=1),
                               mask.chunk(n, dim=1)):
                if torch.is_grad_enabled():
                    total = total + checkpoint(self._ce_sum, h, l, m, use_reentrant=False)
                else:
                    total = total + self._ce_sum(h, l, m)
        else:
            total = self._ce_sum(hidden, labels, mask)
        ce = total / mask.sum().clamp(min=1)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux}

    # -- prefill / decode ----------------------------------------------------------
    def prefill(self, batch):
        """batch {"tokens": (B, S)}, plus ``image_embeds`` (B, F, d) for a
        vision arch, or only ``frame_embeds`` (B, S, d) for an audio arch
        -> (last-position logits (B, V), caches)."""
        with maybe_context(self.policy):
            x = self._embed_inputs(batch)
            hidden, _, caches = self.stack.forward_full(x, self.flags, want_cache=True,
                                                        policy=self.policy)
            logits = self._logits(hidden[:, -1:, :])[:, 0]
        return logits, caches

    def decode_step(self, tokens, caches, pos):
        """tokens: (B, 1); pos: int or (B,) tensor.  Returns (logits (B, V), caches).

        The caches are updated in place and returned.  Under a policy the
        caches are ``ShardingPolicy.cache_shardings``'s DTensors.
        """
        with maybe_context(self.policy):
            x = self._token_embeds(tokens)
            hidden, caches = self.stack.forward_decode(x, caches, pos, self.policy)
            return self._logits(hidden)[:, 0], caches

    def reference_leaves(self):
        """[(parameter names, stacked?)] per leaf of the reference's param
        tree: each weight of the reference's ``scan`` section is one leaf
        stacked over its layer groups (names in group order), every other
        parameter a leaf of its own.  The optimizers read this
        (``train.optimizer``)."""
        leaves = {}
        for name, _ in self.named_parameters():
            key, stacked = name, False
            if name.startswith("stack.layers."):
                idx, rest = name[len("stack.layers."):].split(".", 1)
                section, _, li, _ = self.stack.layout[int(idx)]
                if section == "scan":
                    key, stacked = ("scan", li, rest), True
            leaves.setdefault(key, ([], stacked))[0].append(name)
        return list(leaves.values())

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
