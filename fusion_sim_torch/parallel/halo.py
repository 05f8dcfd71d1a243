"""Explicit halo exchange over a ring of spatial shards (port of
``fusion_sim_tpu/parallel/halo.py``).

The reference's ``lax.ppermute`` rings inside ``shard_map`` become paired
point-to-point messages (``torch.distributed.batch_isend_irecv``) between
ring neighbours of a process group: every rank sends one slab to each
neighbour and receives one from each, all posted in one batch.  On a ring
of two both neighbours are the same rank, and the two messages travel with
distinct tags and buffers in a fixed order.  On a ring of one the
neighbour is the rank itself: the halo is its own opposite slab (what a
one-device ``ppermute`` gives), copied locally with no message.

Arrays are the rank's local blocks; halos come back as separate ``(lo,
hi)`` slabs, so callers choose how to apply them (concatenate for
stencils, accumulate for deposition aprons).  ``group`` is a process
group, a 1D ``DeviceMesh``, or ``None`` for the whole world.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_group


def ring_shift(to_right, to_left, group=None):
    """Send each tensor of ``to_right`` to the next rank of the ring and
    each of ``to_left`` to the previous one; returns ``(from_left,
    from_right)``, the tensors the neighbours sent this way.  One batch of
    paired messages; a ring of one keeps its own tensors."""
    group = axis_group(group)
    n = dist.get_world_size(group)
    if n == 1:
        return list(to_right), list(to_left)
    me = dist.get_rank(group)
    right = dist.get_global_rank(group, (me + 1) % n)
    left = dist.get_global_rank(group, (me - 1) % n)
    to_right = [t.contiguous() for t in to_right]
    to_left = [t.contiguous() for t in to_left]
    from_left = [torch.empty_like(t) for t in to_right]
    from_right = [torch.empty_like(t) for t in to_left]
    ops = []
    # tag 2k carries the k-th rightward tensor, 2k + 1 the k-th leftward
    # one; every rank posts sends and receives in the same order, so a
    # ring of two (left == right) pairs them the same way with or without
    # tags (NCCL ignores them)
    for k, t in enumerate(to_right):
        ops.append(dist.P2POp(dist.isend, t, right, group, tag=2 * k))
    for k, t in enumerate(to_left):
        ops.append(dist.P2POp(dist.isend, t, left, group, tag=2 * k + 1))
    for k, t in enumerate(from_left):
        ops.append(dist.P2POp(dist.irecv, t, left, group, tag=2 * k))
    for k, t in enumerate(from_right):
        ops.append(dist.P2POp(dist.irecv, t, right, group, tag=2 * k + 1))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def _slab(t: torch.Tensor, axis: int, start: int, stop: int):
    return t.narrow(axis, start, stop - start)


def exchange_halo(local: torch.Tensor, group, width: int,
                  array_axis: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange boundary slabs with the ring neighbours: returns
    ``(halo_lo, halo_hi)``, the neighbour slabs adjacent to this shard's
    low and high edges (periodic ring)."""
    size = local.shape[array_axis]
    lo_slab = _slab(local, array_axis, 0, width)
    hi_slab = _slab(local, array_axis, size - width, size)
    # the left neighbour's hi slab is our halo_lo; the right one's lo slab
    # our halo_hi
    (halo_lo,), (halo_hi,) = ring_shift([hi_slab], [lo_slab], group)
    return halo_lo, halo_hi


def with_halo(local: torch.Tensor, group, width: int,
              array_axis: int = 0) -> torch.Tensor:
    """The local block padded with the neighbour halos:
    ``cat(halo_lo, local, halo_hi)``."""
    halo_lo, halo_hi = exchange_halo(local, group, width, array_axis)
    return torch.cat([halo_lo, local, halo_hi], dim=array_axis)


def accumulate_apron(padded: torch.Tensor, group, width: int,
                     array_axis: int = 0) -> torch.Tensor:
    """Fold a deposition apron back onto the neighbours (the inverse of
    ``with_halo`` for scatter-accumulated quantities): the ``width`` apron
    cells beyond each edge of ``padded`` (local + 2*width along
    ``array_axis``) go to the owning neighbour and are added to its edge.
    Returns the local-shaped accumulated block."""
    size = padded.shape[array_axis]
    apron_lo = _slab(padded, array_axis, 0, width)
    apron_hi = _slab(padded, array_axis, size - width, size)
    local = _slab(padded, array_axis, width, size - width).clone()
    # the left neighbour's hi apron lands on our lo edge, the right one's
    # lo apron on our hi edge
    (from_left,), (from_right,) = ring_shift([apron_hi], [apron_lo], group)
    n_loc = local.shape[array_axis]
    _slab(local, array_axis, 0, width).add_(from_left)
    _slab(local, array_axis, n_loc - width, n_loc).add_(from_right)
    return local


def with_halo_2d(local: torch.Tensor, groups, widths: tuple[int, int],
                 array_axes: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Ghost-cell pad along TWO decomposed axes (``groups``: the two mesh
    axes' process groups).  Dimension-ordered: the second exchange ships
    slabs of the already padded array, so the corner cells arrive in two
    hops with no diagonal message."""
    out = with_halo(local, groups[0], widths[0], array_axes[0])
    return with_halo(out, groups[1], widths[1], array_axes[1])


def accumulate_apron_2d(padded: torch.Tensor, groups,
                        widths: tuple[int, int],
                        array_axes: tuple[int, int] = (0, 1)
                        ) -> torch.Tensor:
    """The inverse of ``with_halo_2d`` for scatter-accumulated quantities,
    corners included: folded in the reverse order of the padding, so
    corner contributions ride the first fold into the side aprons."""
    out = accumulate_apron(padded, groups[1], widths[1], array_axes[1])
    return accumulate_apron(out, groups[0], widths[0], array_axes[0])
