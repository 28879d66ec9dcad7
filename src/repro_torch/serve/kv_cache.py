"""Slot-based continuous batching over a shared KV cache (port of ``repro/serve/kv_cache.py``).

``Engine.generate`` serves one whole batch to completion; a production server
instead keeps B slots busy: when a request finishes (EOS or length budget) its
slot is freed and the next queued request is prefilled into it while the other
slots keep decoding.  ``SlotServer`` implements that loop on top of the same
``Model.prefill``/``decode_step``, passing a (B,) position tensor so every
row writes and attends at its own causal frontier.

Slot hygiene: a freed slot's attention K/V rows are overwritten by the next
prefill on [0, prompt_len) and zeroed past it, and every later position is
written by decode before it enters the attention frontier, so stale rows are
never attended.  A Mamba layer's ``state`` and ``conv`` rows of the slot are
overwritten whole (a conv window longer than the prompt is zero past it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import trace


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # prompt token ids (1-D)
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class SlotServer:
    """Continuous-batching server with n_slots concurrent sequences."""

    def __init__(self, model, n_slots: int, max_len: int,
                 eos_id: Optional[int] = None):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.caches = model.empty_caches(n_slots, max_len)
        # bytes of recurrent state (a Mamba layer's state and conv window) a slot holds
        self.slot_state_bytes = sum(t[0].numel() * t.element_size() for c in self.caches
                                    if "state" in c for t in c.values())
        self.pos = np.zeros(n_slots, np.int32)        # next write position
        self.active: List[Optional[Request]] = [None] * n_slots
        self.finished: List[Request] = []
        self._queue: List[Request] = []
        self._next_tok = np.zeros((n_slots, 1), np.int32)

    # -- prefill one request into one slot of the shared caches ---------------
    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        plen = len(req.tokens)
        with trace.span("serve.admit", (req.rid, plen)):
            logits, fresh = self.model.prefill({"tokens": req.tokens[None, :]})
            # The reference merges the batch-1 cache into the shared one with a
            # right-zero-padded dynamic_update_slice; here the slot's rows are
            # written in place, cast to the shared leaf's dtype (Mamba state and
            # conv are fp32 there, prefill's conv is in the model's dtype).  Dim 1
            # of a fresh leaf holds what prefill produced: attention K/V's plen
            # rows, the Mamba state's H heads (all of them), and the conv
            # window's min(plen, K-1) rows.  What it lacks is zeroed, as the
            # reference's pad does, so a prompt shorter than the conv window
            # leaves the window's tail zero there too.
            with trace.span("serve.cache_write"):
                for shared, new in zip(self.caches, fresh):
                    for name, c in shared.items():
                        rows = new[name].shape[1]
                        c[slot, :rows] = new[name][0].to(c.dtype)
                        c[slot, rows:] = 0
            with trace.span("serve.first_token"):
                first = int(torch.argmax(logits[0]))
            req.out.append(first)
            self.active[slot] = req
            self.pos[slot] = plen
            self._next_tok[slot, 0] = first
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.active[slot]
        tok = req.out[-1]
        if (len(req.out) >= req.max_new
                or (self.eos_id is not None and tok == self.eos_id)
                or self.pos[slot] >= self.max_len - 1):
            req.done = True
            self.finished.append(req)
            self.active[slot] = None

    # -- public API -------------------------------------------------------------
    def submit(self, rid: int, tokens, max_new: int) -> None:
        self._queue.append(Request(rid, np.asarray(tokens, np.int32), max_new))

    @torch.inference_mode()
    def step(self) -> int:
        """Fill free slots, then one decode step for all busy slots."""
        with trace.span("serve.step") as span:
            for s in range(self.n_slots):
                if self.active[s] is None and self._queue:
                    self._prefill_into_slot(self._queue.pop(0), s)
            busy = [s for s in range(self.n_slots) if self.active[s] is not None]
            span.arg = len(busy)
            if busy:
                self._decode(busy)
            if trace.enabled():
                trace.count("serve.kv_used", sum(int(self.pos[s]) for s in range(self.n_slots)
                                                 if self.active[s] is not None))
                trace.count("serve.kv_reserved", self.n_slots * self.max_len)
                trace.count("serve.state_bytes", len(busy) * self.slot_state_bytes)
        return len(busy)

    def _decode(self, busy: List[int]) -> None:
        dev = self.model.device
        logits, self.caches = self.model.decode_step(
            torch.as_tensor(self._next_tok, device=dev), self.caches,
            torch.as_tensor(self.pos, device=dev))
        with trace.span("serve.sample"):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            for s in busy:
                self.active[s].out.append(int(nxt[s]))
                self.pos[s] += 1
                self._next_tok[s, 0] = int(nxt[s])
                self._maybe_finish(s)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.step() == 0 and not self._queue:
                break
        return self.finished
