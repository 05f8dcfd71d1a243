"""Placements of the models' state on a mesh (port of
``fusion_sim_tpu/parallel/sharding.py``), as DTensors
(``distribute_tensor`` with ``Shard`` / ``Replicate``).

Two strategies:

* **Particle data-parallel** (``shard_pusher_state``): particle arrays
  split over the ``data`` axis, fields replicated.  Test particles never
  interact, so each rank steps its own rows
  (``dtensor.to_local()``) with the full fields; the moment deposit is a
  sum over ranks (``all_reduce``).
* **Spatial decomposition** (``shard_fields_spatial``, ``shard_em_state``):
  grid arrays split along one spatial axis.  Explicit halos are in
  ``parallel/halo.py``, particle migration in ``parallel/migration.py``.

These functions only place data, as the reference's do.  The reference
then runs its unchanged jitted step on the placed arrays and XLA inserts
the collectives; PyTorch has no such propagation that the port relies on,
so a step runs either on the local blocks (``to_local()``) with explicit
collectives, as the sharded models do, or on ``full_tensor()``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..models.pusher import FieldState, PusherState
from .mesh import NamedSharding


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of NamedTuples, tuples, lists and
    dicts; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _on(mesh, axis: str, placement):
    """Placements with ``placement`` on mesh axis ``axis``, replicated on
    the others."""
    names = mesh.mesh_dim_names or (axis,)
    return NamedSharding(mesh, tuple(placement if n == axis else Replicate()
                                     for n in names))


def shard_pusher_state(state: PusherState, mesh,
                       axis: str = "data") -> PusherState:
    """Particle-DP placement: the (N, ...) arrays split on the particle
    axis, the moment average replicated."""
    part = _on(mesh, axis, Shard(0))
    rep = NamedSharding(mesh, (Replicate(),) * mesh.ndim)
    return PusherState(position=part.put(state.position),
                       velocity=part.put(state.velocity),
                       alive=part.put(state.alive),
                       moments_avg=rep.put(state.moments_avg))


def replicate_pusher_fields(fields: FieldState, mesh) -> FieldState:
    rep = (Replicate(),) * mesh.ndim
    return _tree_map(lambda x: distribute_tensor(x, mesh, list(rep)), fields)


def shard_fields_spatial(fields, mesh, axis: str = "space",
                         array_axis: int = 0):
    """Split every grid tensor of a tree along one spatial axis (where its
    length divides by the axis size; replicated otherwise)."""
    size = mesh.size(mesh.mesh_dim_names.index(axis)
                     if mesh.mesh_dim_names else 0)

    def place(x):
        split = x.dim() > array_axis and x.shape[array_axis] % size == 0
        return _on(mesh, axis, Shard(array_axis) if split
                   else Replicate()).put(x)

    return _tree_map(place, fields)


def shard_em_state(state, mesh, particle_axis: str = "data",
                   space_axis: str | None = None):
    """EM PIC placement: particles over ``particle_axis``; the fields
    replicated (``space_axis=None``) or split along x."""
    part = _on(mesh, particle_axis, Shard(0))
    fspec = (NamedSharding(mesh, (Replicate(),) * mesh.ndim)
             if space_axis is None else _on(mesh, space_axis, Shard(0)))
    return state._replace(position=part.put(state.position),
                          velocity=part.put(state.velocity),
                          e=fspec.put(state.e), b=fspec.put(state.b))
