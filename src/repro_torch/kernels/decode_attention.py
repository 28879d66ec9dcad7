"""K6: one-token GQA decode attention in place on the K/V cache, for Hopper.

Replaces no TPU kernel: the reference's decode attention
(``repro/models/attention.py::decode_attention``) is plain ``jnp``, which XLA
fuses.  The port's plain PyTorch version
(``models.attention.decode_attention_plain``: the rope, the write of the new
row and ``_gqa_attend`` over a masked cache) cannot batch its einsum over
(row, kv head) in the cache's (B, S_max, Hkv, d) layout, so it copies the
whole cache, K and V, in every layer of every decode step, and takes some 70
host dispatches a layer.  ``models.attention.decode_attention`` chooses
between the two: this kernel for a CUDA tensor, the plain version elsewhere
and for a sharded cache.

The CUDA kernel is in ``csrc/decode_attention.cu`` (built by
``kernels.build`` with nvcc for ``sm_90a`` and called through ``ctypes``).
For each row b at position p = ``pos[b]`` it ropes q and the new k in fp32
as ``apply_rope`` does (the wrapper passes ``rope_freqs``' inverse
frequencies, computed once per (d, θ, device)), writes the new k and v rows
into the cache at p, and attends q's heads over positions
max(0, p − window + 1) … p, reading K and V where they lie.  The logits,
the probabilities and P·V stay in fp32 (the plain version rounds the first
two to bf16 in a bf16 model); the output is rounded once, to q's dtype.

What bounds it on an H100: the bytes of the positions attended (about
4·rep flops an element read, far below the ridge).  So the grid is
(splits, Hkv, B), with the split count a function of S_max and B·Hkv alone
(``schedule``), so that rows of unequal length fill the SMs; a split past a
row's frontier exits at once; one block serves all ``rep`` query heads of
its kv head, so K and V are read once, through a two-stage ``cp.async``
ring.  The last split of a row to finish (a ticket per row and kv head)
merges the row's splits in split order: one launch a layer, and the output
is bitwise the same from run to run.

The wrapper reads nothing from the device and never synchronises: its
launch depends on the shapes and the window alone, with the positions read
on the device.  What depends on the shapes alone is made once per shape and
stream (``_PLANS``): the checks, the schedule, the inverse frequencies, the
splits' fp32 scratch and zeroed tickets (reused launch after launch on that
stream, so they are never reused under a launch still running), and a plan
in the C library, so that a call passes the tensors' addresses and nothing
else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import trace
from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 16
SPLIT_ALIGN = 64                  # a split's length is a multiple of every tile
TARGET_BLOCKS = 32 * 132          # blocks were every row full: 32 for each H100 SM
TILES = {torch.float32: 32, torch.bfloat16: 64}   # key rows per ring stage
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PLANS = {}                       # (shapes, dtypes, devices, window, theta, stream) -> _plan


def schedule(s_max: int, rows: int):
    """(splits, split_len) for a cache of ``s_max`` positions and ``rows`` =
    B·Hkv (row, kv head) pairs: about ``TARGET_BLOCKS`` blocks were every row
    full, splits of a multiple of ``SPLIT_ALIGN`` positions, none empty."""
    splits = min(max(1, -(-TARGET_BLOCKS // rows)), -(-s_max // SPLIT_ALIGN))
    split_len = -(-(-(-s_max // splits)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-s_max // split_len), split_len


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        lib.decode_attention_plan.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float]
                                              + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        lib.decode_attention_plan.restype = ctypes.c_int
        lib.decode_attention_run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                             + [ctypes.c_int] + [ctypes.c_void_p] * 2)
        lib.decode_attention_run.restype = ctypes.c_int
        lib.decode_attention_smem.argtypes = [ctypes.c_int] * 3
        lib.decode_attention_smem.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def smem_bytes(dtype, d: int, rep: int) -> int:
    """Dynamic shared memory of the kernel's block at (dtype, d, rep)."""
    n = _lib().decode_attention_smem(_DTYPE_CODES[dtype], d, rep)
    if n < 0:
        raise ValueError(f"no decode_attention kernel for d={d}, rep={rep}")
    return n


def _plan(q, k_new, v_new, cache_k, cache_v, theta, window):
    """Check what the kernel takes at these shapes, then make what a launch
    at them needs: (the C plan's index, the run entry point, the tensors the
    plan points to, kept alive here)."""
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = no window), got {window}")
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4:
        raise ValueError(f"decode_attention wants q (B, 1, H, d) and caches (B, S, Hkv, d), "
                         f"got q {tuple(q.shape)}, cache {tuple(cache_k.shape)}")
    b, _, h, d = q.shape
    _, s_max, hkv, _ = cache_k.shape
    if (cache_v.shape != cache_k.shape or cache_k.shape[0] != b or cache_k.shape[3] != d
            or k_new.shape != (b, 1, hkv, d) or v_new.shape != k_new.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, v_new "
                         f"{tuple(v_new.shape)}, caches {tuple(cache_k.shape)} / "
                         f"{tuple(cache_v.shape)} do not match")
    if h % hkv or not 1 <= h // hkv <= MAX_REP:
        raise ValueError(f"H={h} over Hkv={hkv}: want a GQA ratio of 1 to {MAX_REP}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in (k_new, v_new, cache_k, cache_v)):
        raise ValueError(f"dtypes {q.dtype}/{k_new.dtype}/{v_new.dtype}/{cache_k.dtype}/"
                         f"{cache_v.dtype}: want one of {list(_DTYPE_CODES)} for all five")
    if any(t.device != q.device for t in (k_new, v_new, cache_k, cache_v)):
        raise ValueError("q, k_new, v_new and the caches lie on different devices")
    if b > 65535 or hkv > 65535:
        raise ValueError(f"B={b} or Hkv={hkv} exceeds the grid's 65535")
    from repro_torch.models.layers import rope_freqs   # the models import this module

    splits, split_len = schedule(s_max, b * hkv)
    inv = rope_freqs(d, theta, q.device)
    part = tickets = None
    if splits > 1:
        part = torch.empty(b * hkv * splits * (h // hkv) * (d + 2), dtype=torch.float32,
                           device=q.device)
        tickets = torch.zeros(b * hkv, dtype=torch.int32, device=q.device)
    lib = _lib()
    plan = lib.decode_attention_plan(
        _DTYPE_CODES[q.dtype], b, s_max, hkv, h // hkv, d, window, d ** -0.5, splits,
        split_len, q.device.index, inv.data_ptr(), part.data_ptr() if splits > 1 else None,
        tickets.data_ptr() if splits > 1 else None)
    if plan < 0:
        raise RuntimeError(f"decode_attention refused the plan: cudaError {-plan} "
                           f"({lib.decode_attention_error_string(-plan).decode()})")
    return plan, lib.decode_attention_run, (inv, part, tickets)


def decode_attention(q, k_new, v_new, cache_k, cache_v, pos, theta, *, window=0):
    """One-token decode: q (B, 1, H, d), the new token's k, v (B, 1, Hkv, d)
    before rope, the caches (B, S_max, Hkv, d) written in place at ``pos``
    (an int, or a (B,) tensor of per-row positions) -> o (B, 1, H, d) in q's
    dtype, attended over max(0, p − window + 1) … p (``window`` 0: 0 … p).

    Launches the CUDA kernel or raises; the model takes the plain version
    for tensors elsewhere.  A row whose position lies outside [0, S_max) is
    no error here: it writes nothing and gets zeros, where the plain
    version's index write fails.
    """
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda, not {q.device}")
    with trace.span("k6", q.shape[0]):
        idx = q.get_device()
        stream = build.current_stream(idx)
        key = (q.shape, k_new.shape, v_new.shape, cache_k.shape, cache_v.shape, q.dtype,
               k_new.dtype, v_new.dtype, cache_k.dtype, cache_v.dtype, idx, k_new.get_device(),
               v_new.get_device(), cache_k.get_device(), cache_v.get_device(), window, theta,
               stream)
        plan = _PLANS.get(key)
        if plan is None:
            plan = _PLANS[key] = _plan(q, k_new, v_new, cache_k, cache_v, theta, window)
        if not (q.is_contiguous() and k_new.is_contiguous() and v_new.is_contiguous()
                and cache_k.is_contiguous() and cache_v.is_contiguous()):
            raise ValueError("decode_attention wants contiguous q, k_new, v_new and caches")
        kp, vp = cache_k.data_ptr(), cache_v.data_ptr()
        if kp % 16 or vp % 16:
            raise ValueError("decode_attention wants the caches on 16-byte boundaries")
        if torch.is_tensor(pos):
            if pos.dtype != torch.int32 or pos.get_device() != idx:
                pos = pos.to(device=q.device, dtype=torch.int32)
            if pos.shape != (q.shape[0],) or not pos.is_contiguous():
                pos = pos.reshape(-1).expand(q.shape[0]).contiguous()
            pos_ptr, pos_int = pos.data_ptr(), 0
        else:
            pos_ptr, pos_int = None, int(pos)
        out = torch.empty_like(q)
        err = plan[1](plan[0], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kp, vp,
                      pos_ptr, pos_int, out.data_ptr(), stream)
        if err:
            msg = _lib().decode_attention_error_string(err).decode()
            raise RuntimeError(f"decode_attention launch failed: cudaError {err} ({msg})")
        decode_attention.launches += 1
    return out


decode_attention.launches = 0   # calls that launched the CUDA kernel in this process
