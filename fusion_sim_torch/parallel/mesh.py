"""Device meshes over ``torch.distributed`` (port of
``fusion_sim_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the devices of one
process and runs its sharded steps inside ``shard_map``.  The port runs one
process a rank: each process holds its own shard, and the functions of
``parallel/`` and the sharded models take the mesh (or one of its process
groups) explicitly.  Axis names keep the reference's conventions:

* ``"data"``  — the particle data-parallel axis;
* ``"space"`` — the spatial grid-decomposition axis.

A multi-rank world is started by a launcher (``torchrun --nproc-per-node
N``, or ``torch.multiprocessing``); ``make_mesh`` with one device and no
process group yet starts a world of one itself.  The backend follows the
device: NCCL for ``cuda``, gloo for ``cpu``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from .._device import resolve_device


def make_mesh(n_devices: int | None = None,
              axes: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None,
              device=None) -> DeviceMesh | None:
    """A mesh over the first ``n_devices`` ranks of the world (all of them
    by default), on the card unless ``device="cpu"``.

    1D by default; pass ``axes=("data", "space")`` with ``shape`` for 2D
    meshes.  Every rank of the world must call it; a rank outside the
    first ``n_devices`` gets ``None``.  With no process group yet it joins
    a launcher's world (``torchrun`` sets ``WORLD_SIZE``), or, for one
    device, starts a world of one (an in-memory store, no launcher)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # a rank's card: LOCAL_RANK under torchrun, else the one named
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:       # a launcher's ranks (env://)
            dist.init_process_group(backend)
        elif n_devices in (None, 1):
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            raise RuntimeError(
                f"a mesh of {n_devices} ranks needs a started world: run "
                f"the program under torchrun --nproc-per-node {n_devices}")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"{n_devices} devices requested, the world has "
                         f"{world} ranks")
    if shape is None:
        shape = (n_devices,) if len(axes) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    if n_devices == world:
        return init_device_mesh(dev.type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    mesh = DeviceMesh(dev.type, torch.arange(n_devices).reshape(shape),
                      mesh_dim_names=tuple(axes))
    return mesh if dist.get_rank() < n_devices else None


def axis_group(mesh, axis: str | None = None):
    """The process group of one mesh axis: ``mesh`` is a ``DeviceMesh``
    (``axis`` names the dimension; a 1D mesh needs none), a process group
    (returned as it is), or ``None`` for the whole world."""
    if mesh is None:
        return dist.group.WORLD
    if isinstance(mesh, DeviceMesh):
        if mesh.ndim == 1:
            return mesh.get_group()
        if axis is None:
            raise ValueError("name the axis of a multi-axis mesh")
        return mesh.get_group(axis)
    return mesh


class NamedSharding(NamedTuple):
    """A placement on a mesh (the reference's ``NamedSharding``): DTensor
    placements, one a mesh dimension."""

    mesh: DeviceMesh
    placements: tuple

    def put(self, tensor: torch.Tensor):
        """``tensor`` (the same on every rank) as a DTensor so placed
        (the reference's ``jax.device_put``)."""
        return distribute_tensor(tensor, self.mesh, list(self.placements))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, (Replicate(),) * mesh.ndim)


def sharded_along(mesh: DeviceMesh, axis_name: str, rank: int,
                  array_axis: int = 0) -> NamedSharding:
    """``axis_name`` split over array axis ``array_axis`` of a
    rank-``rank`` array, every other mesh axis replicated."""
    if not 0 <= array_axis < rank:
        raise ValueError(f"array axis {array_axis} of a rank-{rank} array")
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} ({names})")
    return NamedSharding(mesh, tuple(
        Shard(array_axis) if n == axis_name else Replicate() for n in names))


def all_gather_rows(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``tensor`` stacked along axis 0 in rank order (the
    reference's ``all_gather(..., tiled=True)``); bool travels as uint8."""
    group = axis_group(group)
    src = tensor.contiguous()
    if src.dtype == torch.bool:
        return all_gather_rows(src.to(torch.uint8), group).to(torch.bool)
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=group)
    return out
