"""K4: the Mamba-2 SSD chunked scan (forward), for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::_ssd_kernel`` and
its wrapper ``repro/kernels/ops.py::ssd_scan``; the plain version below is
the chunked path of ``repro/models/mamba2.py::ssd_chunked`` (``impl="jnp"``).

The CUDA kernel is ``csrc/ssd_scan.cu`` (built by ``kernels.build`` with nvcc
for ``sm_90a`` and called through ``ctypes``).  One block owns one (batch,
head) and walks its chunks in order, so the (P, N) state is carried in shared
memory where the TPU kernel carried it across a sequential grid axis.  It
reads the model's layouts (x (B, S, H, P), a_log and dt (B, S, H), b and c
(B, S, N)) with no transpose, and masks the ragged last chunk by the real
length where the reference pads with dt = 0; the pads are inert there, so
the final states agree.

What bounds it on an H100: at mamba2-780m's widths (H 48, P 64, N 128) the
Engine's prefill (B 4, S 64) moves about 9.7 MB, 6.3 MB of it the fp32 final
state (2.9 us at 3.35 TB/s), and does about 0.46 GFLOP, so the card's least
time is the bytes; this version computes in fp32 on the CUDA cores (about
7 us of FMAs at 67 TFLOP/s) with one block of 8 warps per SM, so the
shared-memory loads feeding its FMAs bound it.  Its design: 64-row
tiles of the chunk, visiting only the column tiles j <= i, so the Q x Q score
matrix (256 KB at Q = 256) never needs to fit shared memory; the decay
exp(cum_i - cum_j) is computed only where j <= i, where it cannot overflow.
C·Bᵀ is the same for every head of a (batch, chunk) and is recomputed per
head here.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)    # P, a template parameter of the kernel
SUPPORTED_STATE_DIMS = (16, 32, 64, 128)   # N
MAX_CHUNK = 256
TILE = 64                                  # rows of a chunk tile, fixed in csrc/ssd_scan.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pad_seq(t, pad):
    """Zero-pad dim 1 (the sequence) of ``t`` by ``pad`` positions."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_scan_plain(x, a_log, b, c, dt, *, chunk):
    """Plain chunked SSD scan, as ``mamba2.ssd_chunked``'s ``jnp`` path.

    x: (B, S, H, P); a_log, dt: (B, S, H) (a_log = dt * A, negative);
    b, c: (B, S, N).  Returns (y (B, S, H, P) in x's dtype, state
    (B, H, P, N) fp32).  S is padded to a chunk multiple: dt = 0 kills the
    padded inputs and a_log = 0 keeps the state frozen through the pad.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        y, state = ssd_scan_plain(*(_pad_seq(t, pad) for t in (x, a_log, b, c, dt)),
                                  chunk=chunk)
        return y[:, :s], state
    nc, q = s // chunk, chunk

    def chunked(t):
        return t.reshape(bsz, nc, q, *t.shape[2:])

    xc, ac, bc, cc, dtc = map(chunked, (x, a_log, b, c, dt))
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        xq = xc[:, ci].float()                                   # (B,Q,H,P)
        bq, cq = bc[:, ci].float(), cc[:, ci].float()            # (B,Q,N)
        dtq = dtc[:, ci].float()                                 # (B,Q,H)
        cum = torch.cumsum(ac[:, ci].float(), dim=1)             # (B,Q,H)
        # intra-chunk: S[i,j] = (c_i . b_j) * exp(cum_i - cum_j) * dt_j, j <= i
        cb = torch.einsum("bin,bjn->bij", cq, bq)
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])   # (B,i,j,H)
        sm = cb[..., None] * decay * dtq[:, None, :, :]
        sm = torch.where(mask[None, :, :, None], sm, 0.0)
        y = torch.einsum("bijh,bjhp->bihp", sm, xq)
        # inter-chunk: the incoming state's contribution
        y = y + torch.einsum("bin,bhpn,bih->bihp", cq, state, torch.exp(cum))
        # state update
        total = cum[:, -1]                                       # (B,H)
        rem = torch.exp(total[:, None] - cum)                    # (B,Q,H)
        dx = xq * (dtq * rem)[..., None]
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bqhp,bqn->bhpn", dx, bq)
        ys.append(y.to(x.dtype))
    return torch.stack(ys, dim=1).reshape(bsz, s, h, p), state


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        lib.ssd_scan_smem_limit.argtypes = [ctypes.c_int]
        lib.ssd_scan_smem_limit.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory one block of the CUDA kernel needs."""
    return _lib().ssd_scan_smem_bytes(p, n, chunk)


def clamp_chunk(chunk: int, s: int) -> int:
    """The chunk ``ops.ssd_scan`` uses at sequence length s."""
    return min(chunk, max(8, 1 << (s - 1).bit_length()))


def _check(x, a_log, b, c, dt, chunk):
    if x.dim() != 4 or a_log.dim() != 3 or dt.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("ssd_scan wants x (B,S,H,P), a_log and dt (B,S,H), b and c (B,S,N)")
    bsz, s, h, p = x.shape
    if s < 1 or a_log.shape != (bsz, s, h) or dt.shape != (bsz, s, h) or (
            b.shape != c.shape or b.shape[:2] != (bsz, s)):
        raise ValueError(f"shapes x {tuple(x.shape)}, a_log {tuple(a_log.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}, dt {tuple(dt.shape)} "
                         "do not match")
    if p not in SUPPORTED_HEAD_DIMS or b.shape[2] not in SUPPORTED_STATE_DIMS:
        raise ValueError(f"head dim {p} / state dim {b.shape[2]} not in "
                         f"{SUPPORTED_HEAD_DIMS} / {SUPPORTED_STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{b.dtype}/{c.dtype}: want x, b, c all one of "
                         f"{list(_DTYPE_CODES)}")
    if a_log.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError(f"a_log and dt must be float32, got {a_log.dtype}/{dt.dtype}")
    if not all(t.is_contiguous() for t in (x, a_log, b, c, dt)):
        raise ValueError("ssd_scan wants contiguous inputs")
    if len({t.device for t in (x, a_log, b, c, dt)}) != 1:
        raise ValueError("ssd_scan's inputs lie on different devices")


def ssd_scan(x, a_log, b, c, dt, *, chunk=256):
    """Chunked SSD scan -> (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32).

    The chunk is clamped to ``min(chunk, max(8, next_pow2(S)))`` as
    ``ops.ssd_scan`` does.  A CPU tensor goes through ``ssd_scan_plain``.  A
    CUDA tensor launches the CUDA kernel or raises.
    """
    chunk = clamp_chunk(chunk, x.shape[1])
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a_log, b, c, dt, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    _check(x, a_log, b, c, dt, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[2]
    lib = _lib()
    need = lib.ssd_scan_smem_bytes(p, n, chunk)
    limit = lib.ssd_scan_smem_limit(x.device.index)
    if need <= 0 or need > limit:
        raise RuntimeError(f"ssd_scan needs {need} B of shared memory per block at "
                           f"P={p}, N={n}, chunk={chunk}; the device allows {limit} B")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    dev = x.device.index
    err = lib.ssd_scan_fwd(x.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
                           dt.data_ptr(), y.data_ptr(), state.data_ptr(),
                           _DTYPE_CODES[x.dtype], bsz, s, h, p, n, chunk, dev,
                           build.current_stream(dev))
    if err:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err} ({msg})")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0   # launches of the CUDA kernel in this process
