"""Mesh builders (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module never touches
the process group or a device.  Each builder returns a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``pod``, ``data``, ``model``) and shape over the ranks of the
initialised default process group: ``cpu`` meshes under gloo, ``cuda``
meshes under NCCL.  Its size must equal the world's.

The sharding rules (``parallel.sharding``) read only a mesh's axis names
and sizes, so a ``MeshShape`` (the counterpart of JAX's ``AbstractMesh``)
stands in where no world of that size exists: the dry run's 256 and 512
devices, the explore loop's dp·tp boards, the rule tests.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis sizes and names without devices; ``shape`` maps name -> size as
    a JAX mesh's does."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def axes_of(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, sizes) of a ``DeviceMesh`` or a ``MeshShape``."""
    if isinstance(mesh, MeshShape):
        return mesh.axis_names, mesh.sizes
    return tuple(mesh.mesh_dim_names), tuple(mesh.shape)


def _make(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs an initialised process group "
                           "(torch.distributed.init_process_group); use MeshShape "
                           "for the rules alone")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} has {math.prod(shape)} devices, the world "
                         f"{dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 devices per pod; ×2 pods when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes)


def make_mesh_dp_tp(dp: int, tp: int, pods: int = 1):
    """Explicit factorisation (the dp_degree design-space knob)."""
    if pods > 1:
        return _make((pods, dp, tp), ("pod", "data", "model"))
    return _make((dp, tp), ("data", "model"))


def make_host_mesh():
    """A ``("data",)`` mesh over the whole world of the process group; with no
    process group, the size-1 ``MeshShape`` (one process is one device)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return MeshShape((1,), ("data",))
    return _make((dist.get_world_size(),), ("data",))
