"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one source ``csrc/<name>.cu`` with a plain C entry point.  It
is compiled for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so``
at the root of the checkout, where the hash covers the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is compiled when this module is imported: the first launch of a
kernel builds it, or a caller builds several at once with ``build_all``,
which starts one ``nvcc`` per source and waits for all of them.

Every C entry point takes the device index and makes that device current
itself, and the stream as a raw ``cudaStream_t`` (``current_stream``), so
a wrapper's call is the ctypes call and nothing around it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float          # wall time of this process's nvcc run (0 if reused)
    log: str                # nvcc's stderr: the ``-Xptxas -v`` resource report


# Process-wide cache: a shared library is loaded once per process.
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are compiled at first use")
    return str(cand)


def target(name: str) -> tuple:
    """(source path, library path) of kernel ``name``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str], force: bool = False) -> Dict[str, BuildInfo]:
    """Compile the named kernels in parallel (one nvcc each); raise on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    infos, procs = {}, {}
    for name in names:
        src, out = target(name)
        if out.exists() and not force:
            infos[name] = BuildInfo(out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        infos[name] = BuildInfo(out, secs, stdout + stderr)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return infos


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _, out = target(name)
        if not out.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib


def current_stream(device: int) -> int:
    """PyTorch's current stream on CUDA device ``device`` as a raw
    ``cudaStream_t``: ``torch.cuda.current_stream(device).cuda_stream``
    without building a ``Stream`` object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device)
