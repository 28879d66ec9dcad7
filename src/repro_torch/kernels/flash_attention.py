"""K3: causal / sliding-window GQA flash attention (forward), for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
and its wrapper ``repro/kernels/ops.py::flash_attention``; the plain version
below replaces the oracle ``repro/kernels/ref.py::flash_attention_ref``.

The CUDA kernels are in ``csrc/flash_attention.cu`` (built by ``kernels.build``
with nvcc for ``sm_90a`` and called through ``ctypes``).  They read q, k, v
in the model's (B, S, H, d) layout, so there is no transpose and no padding
copy: the ragged sequence edge is masked by the real length.

What bounds it on an H100: at the serving path's shapes (B <= 4, S = 64,
H = 32, d = 128) the bytes (about 2 MB in bf16, ~0.6 us at 3.35 TB/s) and
the latency of one short pass; at long prompts the operations (4 * H * d
flops per attended pair, at the bf16 tensor-core peak, or in fp32 at three
TF32 passes: 495 / 3 TFLOP/s).

bf16 runs on the tensor cores: one warpgroup computes S = Q K^T with
``wgmma`` on a 64-row q tile, keeps the online softmax in fp32 registers,
and adds P V as two ``wgmma``s from registers, on P_hi = bf16(P) and
P_lo = bf16(P - P_hi), so the output stays within one bf16 rounding of the
fp32 computation; the next tile's softmax runs while P V is on the tensor
cores.  A producer warp streams K and V through two-slot rings in shared
memory with TMA and ``mbarrier``s.  The tiles are the kernel's own
(``tiles``): 64 query rows, so a 64-token prompt wastes no rows, and 64
keys, so the fragments stay in registers.

fp32 is ``launch.serve``'s default dtype (and the sharded prefills'), so
it runs on the tensor cores too, in three TF32
passes (``mma.sync`` m16n8k8): hi·hi + hi·lo + lo·hi with hi = tf32(x) and
lo = tf32(x − hi), which keeps about 22 significant bits where one TF32
product keeps 11 and misses the fp32 gate (2e-5).  8 warps a block in two
groups, each on half of every K/V tile, merged at the end; K and V
double-buffered with ``cp.async`` and split once as they land.
``flash_attention_mirror_fp32`` repeats its arithmetic in plain PyTorch
for the tests.  One launch counter counts both dtypes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, tf32

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FITS = set()          # (device, dtype, d) whose shared memory was checked


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None):
    """Plain PyTorch version: q (B, Sq, H, d); k, v (B, Skv, Hkv, d) -> (B, Sq, H, d).

    Follows ``ref.flash_attention_ref``: logits formed in the input dtype and
    then cast to fp32, times ``scale`` (None: d ** -0.5), fp32 softmax, P @ V
    in fp32, cast back to q's dtype.
    """
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    n_rep = h // hkv
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
        v = torch.repeat_interleave(v, n_rep, dim=2)
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32) * scale
    iq = torch.arange(sq, device=q.device)[:, None] + (skv - sq)  # right-aligned
    ik = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ik <= iq
    if window:
        mask &= (iq - ik) < window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p, v.to(torch.float32)).to(q.dtype)


def flash_attention_mirror_fp32(q, k, v, *, causal=True, window=0):
    """The fp32 CUDA kernel's arithmetic in plain PyTorch, for the tests.

    q is pre-scaled by d**-0.5; S = Q Kᵀ and O = P V are each three TF32
    products (``tf32.product3``); P = exp(S − row max), masked entries 0,
    and O is divided by P's row sum at the end.  The kernel's online
    softmax over tiles and its two key groups differ from this one pass
    only by fp32 rounding.  fp32 in, fp32 out.
    """
    if q.dtype != torch.float32 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_mirror_fp32 repeats the fp32 kernel: "
                         "q, k, v must be float32")
    _, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h // hkv > 1:
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
    s = tf32.product3("bqhd,bshd->bhqs", q * d ** -0.5, k)
    iq = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ik = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ik <= iq
    if window:
        mask &= (iq - ik) < window
    s = torch.where(mask[None, None], s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = tf32.product3("bhqs,bshd->bqhd", p, v)
    return o / p.sum(dim=-1).transpose(1, 2)[..., None]


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_config.argtypes = [ctypes.c_int, ctypes.c_int,
                                               ctypes.POINTER(ctypes.c_int)]
        lib.flash_attention_config.restype = ctypes.c_int
        lib.flash_attention_smem_limit.argtypes = [ctypes.c_int]
        lib.flash_attention_smem_limit.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def tiles(d: int, dtype=torch.bfloat16) -> dict:
    """The CUDA kernel's tiles at head dim d: query rows and keys per tile,
    threads and K/V stages per block, and dynamic shared memory bytes."""
    out = (ctypes.c_int * 5)()
    if _lib().flash_attention_config(_DTYPE_CODES[dtype], d, out):
        raise ValueError(f"no flash_attention kernel for head dim {d}")
    return dict(zip(("block_q", "block_kv", "threads", "stages", "smem_bytes"), out))


def _check_fits(device: int, dtype, d: int) -> None:
    """Once per (device, dtype, d): the block's shared memory fits the device."""
    key = (device, dtype, d)
    if key in _FITS:
        return
    need = tiles(d, dtype)["smem_bytes"]
    limit = _lib().flash_attention_smem_limit(device)
    if need > limit:
        raise RuntimeError(f"flash_attention needs {need} B of shared memory per "
                           f"block at d={d}; the device allows {limit} B")
    _FITS.add(key)


def _check(q, k, v, window):
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = no window), got {window}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants q (B,S,H,d) and k, v (B,S,Hkv,d)")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if h % k.shape[2]:
        raise ValueError(f"H={h} is not a multiple of Hkv={k.shape[2]}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want one of "
                         f"{list(_DTYPE_CODES)} for all three")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention wants contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention wants q, k, v on 16-byte boundaries (TMA)")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the grid's 65535 rows")


def flash_attention(q, k, v, *, causal=True, window=0, scale=None, block_q=256, block_kv=256):
    """q: (B, S, H, d); k, v: (B, S, Hkv, d) -> (B, S, H, d), at softmax
    scale ``scale`` (None: d ** -0.5).

    A CPU tensor goes through ``flash_attention_plain``.  A CUDA tensor
    launches the CUDA kernel or raises.  ``block_q``/``block_kv`` are the
    reference wrapper's tile knobs, accepted for parity; the CUDA kernel uses
    its own tiles per head dim (``tiles``), which fit a Hopper block's
    shared memory and registers.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, window)
    b, s, h, d = q.shape
    dev = q.device.index
    _check_fits(dev, q.dtype, d)
    o = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], b, s, h, k.shape[2], d, int(bool(causal)),
        int(window), d ** -0.5 if scale is None else scale, dev, build.current_stream(dev))
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: cudaError {err} ({msg})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0   # launches of the CUDA kernels in this process
