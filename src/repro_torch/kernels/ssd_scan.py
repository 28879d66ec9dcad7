"""K4: the Mamba-2 SSD chunked scan (forward), for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::_ssd_kernel`` and
its wrapper ``repro/kernels/ops.py::ssd_scan``; the plain version below is
the chunked path of ``repro/models/mamba2.py::ssd_chunked`` (``impl="jnp"``).

The CUDA source is ``csrc/ssd_scan.cu`` (built by ``kernels.build`` with nvcc
for ``sm_90a`` and called through ``ctypes``).  It reads the model's layouts
(x (B, S, H, P), a_log and dt (B, S, H), b and c (B, S, N)) with no
transpose, and masks the ragged last chunk by the real length where the
reference pads with dt = 0; the pads are inert there, so the final states
agree.

Both dtypes run on the tensor cores with the chunks in parallel: y blocks
(a 64-row tile of a chunk for one head, C·Bᵀ formed in registers) and
state blocks (each chunk's local state ΔS for 64 columns of N) in one
launch; with more than one chunk a state pass then forms each chunk's
incoming state and a second launch of y blocks adds its term.
``schedule`` gives the grids and ``block_work`` what each block computes,
as the C code decodes it (the card tests hold the two against the C
library's own ``ssd_scan_grids``/``ssd_scan_block``).  bf16 feeds its three
fp32 intermediates (S, the incoming state, dx) to the tensor cores as bf16
high and low parts; fp32, ``launch.serve``'s default dtype, splits every
operand into TF32 high and low parts and adds three products (hi·hi +
hi·lo + lo·hi), about 22 significant bits where one TF32 product keeps 11.
``ssd_scan_mirror`` repeats either dtype's pass order and splits in plain
PyTorch, for the tests.  Both count one launch per call.

What bounds it on an H100: at mamba2-780m's widths (H 48, P 64, N 128) the
Engine's prefill (B 4, S 64) moves about 9.7 MB in bf16, 6.3 MB of it the
fp32 state (2.9 us at 3.35 TB/s), and does about 0.46 GFLOP (0.5 us at the
bf16 tensor-core peak), so the card's least time is the bytes; in fp32 a
600-token prompt and a (4, 512) prefill are bound by the operations at
three TF32 passes (495 / 3 TFLOP/s).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, tf32

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)    # P, a template parameter of the kernel
SUPPORTED_STATE_DIMS = (16, 32, 64, 128)   # N
MAX_CHUNK = 256
TILE = 64                                  # rows of a chunk tile (csrc: TILE)
STATE_COLS = 64                            # columns of N per state block (csrc: STATE_COLS)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FITS = set()                              # (device, dtype, P, N, chunk) checked


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


def _split(t):
    """An fp32 tensor as a bf16 high part and the bf16 rounding of the rest
    (both held in fp32): the two operands the kernel feeds a tensor core."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _product(eq, a, b, dtype):
    """``einsum(eq, a, b)`` as the kernel of ``dtype`` forms it: in bf16,
    ``a`` (an fp32 intermediate, or an exact bf16 operand, whose low part is
    then 0) split high + low against the exact bf16 ``b``, two products; in
    fp32, both split into TF32 parts, three products (``tf32.product3``)."""
    if dtype == torch.float32:
        return tf32.product3(eq, a, b)
    hi, lo = _split(a)
    return torch.einsum(eq, hi, b) + torch.einsum(eq, lo, b)


def ssd_scan_mirror(x, a_log, b, c, dt, *, chunk):
    """The CUDA kernel's arithmetic in plain PyTorch, for the tests.

    Its pass order: each chunk's local state ΔS = dxᵀ·B from zero, with
    dx = x·dt·exp(total − cum); the state pass
    state_in(c+1) = state_in(c)·exp(total_c) + ΔS_c; then y per chunk,
    exp(cum_i)·(c_i · state_in), plus S·X with
    S = (C·Bᵀ) ∘ exp(cum_i − cum_j) ∘ dt_j (j ≤ i).  Each product as
    ``_product`` forms it: bf16 splits the three fp32 intermediates (dx,
    state_in, S) high + low against the exact bf16 C, B and X; fp32 splits
    every operand into TF32 parts.  Products accumulate in fp32.
    ``chunk`` is used as given (the wrapper clamps it first); the ragged
    last chunk is cut, not padded.  Returns (y in x's dtype, state fp32).
    """
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError("ssd_scan_mirror repeats the kernel: x, b, c must be all "
                         "bfloat16 or all float32")
    dtype = x.dtype
    bsz, s, h, p = x.shape
    xf, bf, cf = x.float(), b.float(), c.float()
    spans = [slice(c0, min(s, c0 + chunk)) for c0 in range(0, s, chunk)]
    cums = [torch.cumsum(a_log[:, sl].float(), dim=1) for sl in spans]       # (B, L, H)
    ds, totals = [], []
    for sl, cum in zip(spans, cums):                  # the state blocks
        total = cum[:, -1]                                                   # (B, H)
        w = dt[:, sl].float() * torch.exp(total[:, None] - cum)
        ds.append(_product("blhp,bln->bhpn", xf[:, sl] * w[..., None], bf[:, sl], dtype))
        totals.append(total)
    state = torch.zeros_like(ds[0])
    state_in = []
    for d, total in zip(ds, totals):                  # the state pass
        state_in.append(state)
        state = state * torch.exp(total)[:, :, None, None] + d
    ys = []
    for ci, (sl, cum) in enumerate(zip(spans, cums)):  # the y blocks
        cq, bq, xq = cf[:, sl], bf[:, sl], xf[:, sl]
        n_rows = cq.shape[1]
        y = torch.zeros((bsz, n_rows, h, p), dtype=torch.float32, device=x.device)
        if ci:
            y = (_product("bhpn,bin->bihp", state_in[ci], cq, dtype)
                 * torch.exp(cum)[..., None])
        mask = torch.tril(torch.ones((n_rows, n_rows), dtype=torch.bool, device=x.device))
        mask = mask[None, :, :, None]
        diff = torch.where(mask, cum[:, :, None, :] - cum[:, None, :, :], 0.0)
        sm = _product("bin,bjn->bij", cq, bq, dtype)[..., None] * torch.exp(diff)
        sm = torch.where(mask, sm * dt[:, sl].float()[:, None, :, :], 0.0)
        ys.append(y + _product("bijh,bjhp->bihp", sm, xq, dtype))
    return torch.cat(ys, dim=1).to(x.dtype), state


def schedule(bsz: int, s: int, h: int, p: int, n: int, chunk: int) -> dict:
    """The kernel's grid for one call of either dtype (chunk as clamped):
    chunks, 64-row tiles per chunk, state blocks per (chunk, head), and each
    launch's blocks, as ``csrc/ssd_scan.cu::grids`` counts them (the chunk
    kernel; with more than one chunk also the state pass and the chunk
    kernel's y blocks for the chunks after the first)."""
    nc, n_it, parts = -(-s // chunk), -(-chunk // TILE), -(-n // STATE_COLS)
    grids = [n_it * bsz * h + nc * bsz * h * parts]
    if nc > 1:
        grids += [-(-bsz * h * p * n // 4 // 256), (nc - 1) * n_it * bsz * h]
    return {"n_chunks": nc, "row_tiles": n_it, "state_parts": parts, "grids": grids}


def block_work(bsz: int, s: int, h: int, n: int, chunk: int, launch: int, blk: int):
    """What block ``blk`` of chunk-kernel launch ``launch`` (0 or 1) computes,
    as ``csrc/ssd_scan.cu::block_work`` decodes it: ("y", b, c, h, row tile),
    ("state", b, c, h, part of N), or None for a y block whose row tile
    starts past its chunk's end.  y blocks come first, their row tiles from
    the last down; launch 0 holds the first chunk's and every state block."""
    n_it, parts = -(-chunk // TILE), -(-n // STATE_COLS)
    n_y = ((-(-s // chunk) - 1) if launch else 1) * n_it * bsz * h
    if blk < n_y:
        per_it = n_y // n_it
        kind, tile, rest = "y", n_it - 1 - blk // per_it, blk % per_it
    else:
        kind, tile, rest = "state", (blk - n_y) % parts, (blk - n_y) // parts
    hh, rest = rest % h, rest // h
    c = rest // bsz + (launch if kind == "y" else 0)
    if kind == "y" and tile * TILE >= min(chunk, s - c * chunk):
        return None
    return kind, rest % bsz, c, hh, tile


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.ssd_scan_fwd.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.ssd_scan_fwd.restype = i
        lib.ssd_scan_config.argtypes = [p]
        lib.ssd_scan_config.restype = None
        lib.ssd_scan_grids.argtypes = [i] * 6 + [p]
        lib.ssd_scan_grids.restype = i
        lib.ssd_scan_block.argtypes = [i] * 8 + [p]
        lib.ssd_scan_block.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i] * 4
        lib.ssd_scan_smem_bytes.restype = i
        lib.ssd_scan_smem_limit.argtypes = [i]
        lib.ssd_scan_smem_limit.restype = i
        lib.ssd_scan_fill_smem.argtypes = [ctypes.c_float, i, p]
        lib.ssd_scan_fill_smem.restype = i
        lib.ssd_scan_error_string.argtypes = [i]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        out = (ctypes.c_int * 3)()
        lib.ssd_scan_config(out)
        if (out[0], out[1]) != (TILE, STATE_COLS):
            raise RuntimeError(f"csrc/ssd_scan.cu has TILE {out[0]}, STATE_COLS {out[1]}; "
                               f"ssd_scan.py has {TILE}, {STATE_COLS}")
        lib._typed = True
    return lib


def kernel_grids(bsz: int, s: int, h: int, p: int, n: int, chunk: int) -> list:
    """Each launch's blocks of a call, as the C library counts them."""
    out = (ctypes.c_longlong * 3)()
    count = _lib().ssd_scan_grids(bsz, s, h, p, n, chunk, out)
    if not count:
        raise ValueError(f"unsupported sizes B {bsz}, S {s}, H {h}, P {p}, N {n}, chunk {chunk}")
    return list(out[:count])


def kernel_block_work(bsz, s, h, p, n, chunk, launch, blk):
    """``block_work`` as the C library decodes it (the kernel's own decode)."""
    out = (ctypes.c_int * 5)()
    if _lib().ssd_scan_block(bsz, s, h, p, n, chunk, launch, blk, out):
        raise ValueError(f"no block {blk} in launch {launch}")
    kind, bi, c, hh, tile = out
    return None if kind < 0 else ("y" if kind == 0 else "state", bi, c, hh, tile)


def fill_shared_memory(value: float, device: int) -> None:
    """Write ``value`` over every SM's shared memory on ``device`` (for
    tests: the next kernel must not read shared memory it did not write)."""
    lib = _lib()
    err = lib.ssd_scan_fill_smem(value, device, build.current_stream(device))
    if err:
        raise RuntimeError(f"fill_shared_memory failed: cudaError {err} "
                           f"({lib.ssd_scan_error_string(err).decode()})")


def smem_bytes(p: int, n: int, chunk: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory one block of the CUDA kernel needs in ``dtype``."""
    return _lib().ssd_scan_smem_bytes(_DTYPE_CODES[dtype], p, n, chunk)


def _check_fits(device: int, dtype, p: int, n: int, chunk: int) -> None:
    """Once per (device, dtype, P, N, chunk): the block's shared memory fits."""
    key = (device, dtype, p, n, chunk)
    if key in _FITS:
        return
    need = smem_bytes(p, n, chunk, dtype)
    limit = _lib().ssd_scan_smem_limit(device)
    if need <= 0 or need > limit:
        raise RuntimeError(f"ssd_scan needs {need} B of shared memory per block at "
                           f"P={p}, N={n}, chunk={chunk}; the device allows {limit} B")
    _FITS.add(key)


def clamp_chunk(chunk: int, s: int) -> int:
    """The chunk ``ops.ssd_scan`` uses at sequence length s."""
    return min(chunk, max(8, 1 << (s - 1).bit_length()))


def _check(x, a_log, b, c, dt, chunk):
    ts = (x, a_log, b, c, dt)
    if x.dim() != 4 or a_log.dim() != 3 or dt.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError("ssd_scan wants x (B,S,H,P), a_log and dt (B,S,H), b and c (B,S,N)")
    bsz, s, h, p = x.shape
    if s < 1 or not a_log.shape == dt.shape == (bsz, s, h) or (
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
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_scan wants contiguous inputs")
    if len({t.get_device() for t in ts}) != 1:
        raise ValueError("ssd_scan's inputs lie on different devices")
    if (x.data_ptr() | b.data_ptr() | c.data_ptr()) % 16:
        raise ValueError("ssd_scan wants x, b, c on 16-byte boundaries (cp.async)")


def ssd_scan(x, a_log, b, c, dt, *, chunk=256):
    """Chunked SSD scan -> (y (B, S, H, P) in x's dtype, final state (B, H, P, N) fp32).

    The chunk is clamped to ``min(chunk, max(8, next_pow2(S)))`` as
    ``ops.ssd_scan`` does.  A CPU tensor goes through ``ssd_scan_plain``.  A
    CUDA tensor launches the CUDA kernels (one launch, or three with more
    than one chunk) or raises; either way ``ssd_scan.launches`` counts one.
    """
    chunk = clamp_chunk(chunk, x.shape[1])
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a_log, b, c, dt, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    _check(x, a_log, b, c, dt, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[2]
    dev = x.device.index
    work = None
    if s > chunk:
        work = a_log.new_empty(bsz * -(-s // chunk) * h * (2 * p * n + 1))
    _check_fits(dev, x.dtype, p, n, chunk)
    y = torch.empty_like(x)
    state = a_log.new_empty((bsz, h, p, n))
    lib = _lib()
    err = lib.ssd_scan_fwd(x.data_ptr(), a_log.data_ptr(), b.data_ptr(), c.data_ptr(),
                           dt.data_ptr(), y.data_ptr(), state.data_ptr(),
                           None if work is None else work.data_ptr(),
                           _DTYPE_CODES[x.dtype], bsz, s, h, p, n, chunk, dev,
                           build.current_stream(dev))
    if err:
        msg = lib.ssd_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err} ({msg})")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0   # calls that launched the CUDA kernels in this process
