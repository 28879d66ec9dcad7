"""Checkpointing: atomic, async, keep-k (port of ``repro/train/checkpoint.py``).

The reference's on-disk contract: ``<dir>/step_<N>/`` (N zero-padded to 8
digits) with one ``.npy`` per leaf of the state, ``leaf_<i>.npy`` in sorted
key order, plus ``manifest.json`` (``{"step", "leaves": {key: {"file",
"shape", "dtype"}}}``, keys the "/"-joined paths of the nested dict).
Writes go to a ``.tmp-`` directory first and are renamed into place, so a
torn write is never mistaken for a checkpoint; only the newest ``keep``
survive.  ``save`` copies every leaf to host memory synchronously (the
caller may then overwrite the state in place) and writes on a thread.

bfloat16 leaves are written as their uint16 bits with ``"bfloat16"`` in the
manifest (numpy has no bfloat16 of its own).  ``restore`` places each leaf
on the device and in the dtype of the template's leaf; given the ``cfg`` of
the arch, it also reads a checkpoint the reference wrote (keys such as
``params/embed/table``, scanned layer groups stacked), through
``models.convert.train_state_from_jax``.

A sharded state (DTensor leaves, ``parallel.sharding``) is written as the
same full arrays: every rank takes part in gathering each leaf, and rank 0
alone writes (and prunes).  ``restore`` places each leaf in its template
leaf's placements, every rank slicing its own share of the full array.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import is_distributed


def _flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if is_distributed(t):
        t = t.full_tensor()
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.require(a, requirements="C").view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.require(a, requirements="C"))


def _like(template: Any, values: Dict[str, torch.Tensor], prefix: str = "") -> Any:
    out = {}
    for key, leaf in template.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, dict):
            out[key] = _like(leaf, values, name + "/")
        elif name not in values:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        elif is_distributed(leaf):
            from torch.distributed.tensor import distribute_tensor

            out[key] = distribute_tensor(values[name].to(device=leaf.device, dtype=leaf.dtype),
                                         leaf.device_mesh, leaf.placements, src_data_rank=None)
        else:
            out[key] = values[name].to(device=leaf.device, dtype=leaf.dtype)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = False) -> None:
        # snapshot to host memory synchronously, write async
        flat = {k: (_to_numpy(v), "bfloat16" if v.dtype == torch.bfloat16 else None)
                for k, v in sorted(_flatten(state).items())}
        if _rank() != 0:
            return
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def _write(self, step: int, flat) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = os.path.join(self.directory, f".tmp-step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for i, (key, (arr, dtype_name)) in enumerate(sorted(flat.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype_name or str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: int) -> Dict[str, torch.Tensor]:
        """The checkpoint's leaves as CPU tensors, keyed as in its manifest."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        return {key: _from_numpy(np.load(os.path.join(d, meta["file"])), meta["dtype"])
                for key, meta in manifest["leaves"].items()}

    def restore(self, step: int, template: Any, cfg=None) -> Any:
        """A tree like ``template`` with the checkpoint's values, each leaf on
        its template leaf's device and in its dtype.  With ``cfg``, a
        checkpoint the reference wrote is converted first."""
        values = self.load(step)
        if cfg is not None and "params/embed/table" in values:
            from repro_torch.models.convert import train_state_from_jax, unflatten

            values = _flatten(train_state_from_jax(unflatten(values), cfg))
        return _like(template, values)
