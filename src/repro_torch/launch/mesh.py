"""Production meshes.

The port of ``repro.launch.mesh``.  ``make_production_mesh`` is a
FUNCTION (importing this module touches no process group): single-pod
16×16 = 256 cards, axes ("data", "model"); multi-pod 2×16×16 = 512
cards, axes ("pod", "data", "model") — the "pod" axis crosses hosts.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` or, where
no process group exists, a plain mapping of axis name to size (the
port's counterpart of JAX's ``AbstractMesh``): the sharding rules read
only names and sizes.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_production_mesh", "fsdp_axes", "dp_axes", "MESH_AXES", "axis_names",
           "axis_sizes"]

MESH_AXES = {
    False: (("data", "model"), (16, 16)),
    True: (("pod", "data", "model"), (2, 16, 16)),
}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The 16×16 (or 2×16×16) mesh over the first 256 (512) ranks of the
    default process group, which the caller starts first (the dry-run
    starts one of 512 ranks on the ``fake`` backend)."""
    names, shape = MESH_AXES[multi_pod]
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh: no process group; start one of at least "
                           f"{n} ranks first (launch.dryrun starts the 'fake' backend)")
    if dist.get_world_size() < n:
        raise RuntimeError(f"make_production_mesh: the {shape} mesh needs {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names, major first."""
    if isinstance(mesh, Mapping):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """Axis name -> size."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def fsdp_axes(mesh) -> tuple[str, ...]:
    """Axes parameters are FSDP-sharded over (pod+data when present)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes the batch dimension is sharded over."""
    return fsdp_axes(mesh)
