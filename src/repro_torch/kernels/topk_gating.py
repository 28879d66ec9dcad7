"""K5: fused MoE router gating (softmax over E, then top-k), for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/topk_gating.py::_gating_kernel``
and its wrapper ``repro/kernels/ops.py::topk_gating``; the plain version below
computes what the oracle ``repro/kernels/ref.py::topk_gating_ref`` and the
reference MoE (``repro/models/moe.py``: ``softmax`` then ``lax.top_k``)
compute, ties included: among equal probabilities the lower expert index
comes first.

The CUDA kernel is ``csrc/topk_gating.cu`` (built by ``kernels.build`` with
nvcc for ``sm_90a`` and called through ``ctypes``): one warp per token row,
the softmax's max and sum through shuffles, then k argmax-and-mask steps
(k up to a warp's 32 lanes: deepseek-moe-16b's 6 of 64, granite-4.0-h's 10
of 72).
It masks the ragged T itself, so there is no ``block_t`` padding.

What bounds it on an H100: at deepseek-moe-16b's router (E = 64, k = 6) the
row count is at most a few hundred, so it moves tens of KB and the launch
dominates; a call's time is the wrapper's host path.  So the wrapper keeps
that path short: its checks, the outputs' allocations (``out_buffers``),
the raw current stream and one ctypes call, to which it passes the device
index (the C side switches device only when it differs).

Training differentiates the router through the gate probabilities.  The
reference leaves that to XLA's autodiff of its plain gating; here the
wrapper, when its logits need a gradient, runs inside ``TopkGating``, an
``autograd.Function`` whose forward is the same call (K5 on the card, the
plain version on the CPU) and whose backward is plain PyTorch: with p the
softmax of the saved logits recomputed and g the gradient of ``top_p``,
dL/dlogits = p ⊙ (scatter(g) − Σ_k g·top_p).  The ids carry no gradient.
The counter counts forward launches only, so a training step under
activation checkpointing counts K5 once for the forward and once for the
recompute.  It counts the wrapper's calls: in a decode step captured as a
CUDA graph (``Model.decode_step``) K5 counts, and its ``k5`` span fires,
once at the capture and not on the graph's replays.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import trace
from repro_torch.kernels import build

MAX_EXPERTS = 256
MAX_K = 32          # the kernel keeps result i in lane i of the row's warp


def topk_gating_plain(logits, k):
    """logits (T, E) -> (top_p (T, k) fp32, top_ids (T, k) int32).

    ``exp(x - max) / sum`` as the Pallas kernel writes it, then a stable
    descending sort, which keeps equal probabilities in index order
    (``torch.topk`` does not promise that order).
    """
    x = logits if logits.dtype == torch.float64 else logits.float()
    ex = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    probs = ex / ex.sum(dim=-1, keepdim=True)
    top_p, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k].contiguous(), top_ids[:, :k].to(torch.int32).contiguous()


def _lib() -> ctypes.CDLL:
    lib = build.load("topk_gating")
    if not getattr(lib, "_typed", False):
        lib.topk_gating_fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
        lib.topk_gating_fwd.restype = ctypes.c_int
        lib.topk_gating_error_string.argtypes = [ctypes.c_int]
        lib.topk_gating_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def out_buffers(logits, k):
    """K5's two contiguous (T, k) outputs beside fp32 ``logits`` (T, E):
    fp32 probabilities and int32 ids, made the cheapest way measured on the
    card's host (``chip_smoke.py``'s ``topk_host_path``): ``new_empty`` of
    the logits, which takes their device and dtype without parsing either,
    then ``torch.empty_like`` of it.  One (2, T, k) allocation with a view
    per plane cost more than two allocations, the views' dispatch eating
    the saving."""
    top_p = logits.new_empty((logits.shape[0], k))
    return top_p, torch.empty_like(top_p, dtype=torch.int32)


def _check(logits, k):
    if logits.dim() != 2 or logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError(f"topk_gating wants contiguous (T, E) float32 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    t, e = logits.shape
    if t < 1 or not 1 <= e <= MAX_EXPERTS or not 1 <= k <= min(MAX_K, e):
        raise ValueError(f"topk_gating takes T >= 1, E <= {MAX_EXPERTS} and "
                         f"k <= min({MAX_K}, E); got T={t}, E={e}, k={k}")


def topk_gating(logits, k):
    """Softmax over the last axis of ``logits`` (T, E), then its top ``k``.

    Returns (top_p (T, k) fp32, top_ids (T, k) int32).  A CPU tensor goes
    through ``topk_gating_plain`` (float64 logits stay float64 there, for
    ``gradcheck``).  A CUDA tensor launches the CUDA kernel or raises.  A
    ``meta`` tensor (the explore loop's build, which counts and allocates
    nothing) gets the outputs' shapes and launches nothing.  Logits that
    need a gradient go through ``TopkGating``.
    """
    if logits.requires_grad and torch.is_grad_enabled():
        return TopkGating.apply(logits, k)
    return _forward(logits, k)


def _forward(logits, k):
    dev = logits.device
    if dev.type == "cpu":
        return topk_gating_plain(logits, k)
    if dev.type == "meta":
        _check(logits, k)
        return out_buffers(logits, k)
    if dev.type != "cuda":
        raise ValueError(f"topk_gating runs on cuda or cpu, not {dev}")
    with trace.span("k5", (logits.shape[0], k)):
        _check(logits, k)
        t, e = logits.shape
        top_p, top_ids = out_buffers(logits, k)
        lib = _lib()
        err = lib.topk_gating_fwd(logits.data_ptr(), top_p.data_ptr(), top_ids.data_ptr(),
                                  t, e, k, dev.index, build.current_stream(dev.index))
        if err:
            msg = lib.topk_gating_error_string(err).decode()
            raise RuntimeError(f"topk_gating launch failed: cudaError {err} ({msg})")
        topk_gating.launches += 1
    return top_p, top_ids


topk_gating.launches = 0   # calls that launched (or captured) the CUDA kernel in this process


def topk_gating_backward(logits, top_p, top_ids, grad_p):
    """dL/dlogits of ``top_p`` = softmax(logits)[top_ids], given dL/dtop_p.

    With p = softmax(logits): dp_i/dx_m = p_i (δ_im − p_m), so
    dL/dx = p ⊙ (scatter(g) − Σ_k g·top_p).  The ids of a row are distinct,
    so the scatter adds one value to each place it writes."""
    x = logits if logits.dtype == torch.float64 else logits.float()
    p = torch.softmax(x, dim=-1)
    g = grad_p.to(p.dtype)
    scat = torch.zeros_like(p).scatter_add_(1, top_ids.long(), g)
    dot = (g * top_p.to(p.dtype)).sum(dim=-1, keepdim=True)
    return (p * (scat - dot)).to(logits.dtype)


class TopkGating(torch.autograd.Function):
    """K5 (or its plain version on the CPU) forward, plain PyTorch backward."""

    @staticmethod
    def forward(ctx, logits, k):
        top_p, top_ids = _forward(logits, k)
        ctx.save_for_backward(logits, top_p, top_ids)
        ctx.mark_non_differentiable(top_ids)
        return top_p, top_ids

    @staticmethod
    def backward(ctx, grad_p, grad_ids):
        logits, top_p, top_ids = ctx.saved_tensors
        return topk_gating_backward(logits, top_p, top_ids, grad_p), None
