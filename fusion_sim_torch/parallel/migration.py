"""Particle migration between spatial shards: a fixed-capacity ring
exchange (port of ``fusion_sim_tpu/parallel/migration.py``).

When the grid is split into slabs, particles drifting across a slab
boundary move to the neighbour shard.  Every shape stays fixed:

1. classify each particle: stay / send left / send right (the caller's
   masks, from its coordinate against the local slab, assuming less than
   half a slab of motion a step);
2. pack the leavers into (capacity, ...) buffers with a validity mask
   (leavers past the capacity are counted as overflow and dropped);
3. send the buffers round the ring both ways (``halo.ring_shift``: paired
   messages between neighbours, a local copy on a ring of one);
4. merge the arrivals into vacated slots (each shard keeps a fixed number
   of rows; empty slots are flagged dead).

The reference's ``_as_columns`` splits (N, d) arrays into columns around
its gathers to dodge a TPU layout padding; the port gathers rows as they
are, with the same results.  Its sorts are stable ``torch.argsort``es,
like ``jnp.argsort``, so a rank's rows come out as the reference's shard's
do, row for row.  Counts are int64 tensors on the rows' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .halo import ring_shift


class MigrationResult(NamedTuple):
    arrays: tuple               # per-field (N, ...) arrays after migration
    alive: torch.Tensor         # (N,) bool — live occupancy after the merge
    overflow: torch.Tensor      # leavers dropped for lack of capacity


class StackedMigrationResult(NamedTuple):
    arrays: tuple               # per-field (N, ...) arrays after migration
    alive: torch.Tensor         # (N,) bool
    overflow: torch.Tensor      # leavers dropped + arrivals with no slot
    free_idx: torch.Tensor      # updated per-tile dead-slot stacks
    free_cnt: torch.Tensor
    spare_idx: torch.Tensor     # updated spare stack (trailing slots)
    spare_cnt: torch.Tensor
    placed_tile: torch.Tensor   # arrivals seated in their tile's segment
    placed_spare: torch.Tensor  # arrivals seated in spare slots


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Stable order with the rows where ``mask`` holds first."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)


def _pack(arrays, mask: torch.Tensor, capacity: int, with_take: bool = False):
    """Gather the rows where ``mask`` holds into fixed (capacity, ...)
    buffers, in row order.  Returns ``(buffers, valid, overflow[, take])``:
    rows beyond ``capacity`` count as overflow; ``take`` holds the packed
    rows' source indices."""
    order = _first_true(mask)
    if order.shape[0] < capacity:    # fewer rows than buffer slots
        order = torch.cat([order, order.new_zeros(capacity - order.shape[0])])
    count = mask.sum()
    take = order[:capacity]
    valid = (torch.arange(capacity, device=mask.device)
             < torch.clamp(count, max=capacity))
    buffers = tuple(a[take] for a in arrays)
    overflow = torch.clamp(count - capacity, min=0)
    if with_take:
        return buffers, valid, overflow, take
    return buffers, valid, overflow


def _exchange(send_l, valid_l, send_r, valid_r, group):
    """Send the left buffers to the left neighbour and the right ones to
    the right; returns the arrivals (from the left, then from the right)
    and their validity."""
    from_left, from_right = ring_shift(
        [*send_r, valid_r.to(torch.uint8)], [*send_l, valid_l.to(torch.uint8)],
        group)
    arrivals = tuple(torch.cat([a, b]) for a, b in
                     zip(from_left[:-1], from_right[:-1]))
    valid = torch.cat([from_left[-1], from_right[-1]]).to(torch.bool)
    return arrivals, valid


def _set_drop(a: torch.Tensor, index: torch.Tensor, values: torch.Tensor):
    """``a.at[index].set(values, mode='drop')``: entries at ``len(a)`` are
    dropped (written to a scratch row)."""
    out = torch.cat([a, a[:1]])
    out[index] = values.to(a.dtype)
    return out[:a.shape[0]]


def migrate_ring(arrays: tuple, alive: torch.Tensor, go_left: torch.Tensor,
                 go_right: torch.Tensor, group, capacity: int
                 ) -> MigrationResult:
    """Exchange leavers with the ring neighbours of ``group``.

    ``arrays``: per-particle tensors, each (N, ...); ``alive``: (N,) bool;
    ``go_left``/``go_right``: (N,) bool (subsets of alive)."""
    send_l, valid_l, ov_l = _pack(arrays, alive & go_left, capacity)
    send_r, valid_r, ov_r = _pack(arrays, alive & go_right, capacity)
    stay = alive & ~(go_left | go_right)
    arrivals, arrivals_valid = _exchange(send_l, valid_l, send_r, valid_r,
                                         group)

    # merge: free slots = not stay; fill them with the arrivals (from the
    # left, then from the right), compacted to the front
    n = alive.shape[0]
    free_order = torch.argsort(stay.to(torch.uint8), stable=True)
    arr_order = _first_true(arrivals_valid)
    arrivals = tuple(a[arr_order] for a in arrivals)
    n_arrive = arrivals_valid.sum()
    slot_idx = free_order[:2 * capacity]
    k = slot_idx.shape[0]
    n_free = n - stay.sum()
    use = (torch.arange(k, device=alive.device)
           < torch.minimum(n_arrive, n_free))
    out = []
    for a, arr in zip(arrays, arrivals):
        shaped = use.reshape((-1,) + (1,) * (a.dim() - 1))
        a = a.clone()
        a[slot_idx] = torch.where(shaped, arr[:k].to(a.dtype), a[slot_idx])
        out.append(a)
    new_alive = stay.clone()
    new_alive[slot_idx] = use | stay[slot_idx]
    overflow = ov_l + ov_r + torch.clamp(n_arrive - n_free, min=0)
    return MigrationResult(arrays=tuple(out), alive=new_alive,
                           overflow=overflow)


def migrate_ring_stacked(arrays: tuple, alive: torch.Tensor,
                         go_left: torch.Tensor, go_right: torch.Tensor,
                         group, capacity: int, tile_id: torch.Tensor,
                         n_tiles: int, arrival_tiles_fn,
                         free_idx: torch.Tensor, free_cnt: torch.Tensor,
                         spare_idx: torch.Tensor, spare_cnt: torch.Tensor
                         ) -> StackedMigrationResult:
    """``migrate_ring`` for the repair layouts, whose dead slots belong to
    the per-tile free stacks (ops/repair.py): leavers push their slots
    back on (a trailing-region slot onto the spare stack), and arrivals
    pop a slot of their tile's stack first (then they are in their window
    at once), else one of the spare stack.

    ``tile_id``: (N,) the layout's block tile per row (>= ``n_tiles`` on
    the trailing blocks); ``arrival_tiles_fn(arrival_arrays) -> (K,)``
    maps the arrivals to their tile on this shard's pseudo-grid.  Arrivals
    that neither stack can seat are dropped and counted in ``overflow``;
    leaver slots pushed past a stack's capacity leak until the next
    resort."""
    from ..ops.repair import pop_slots, push_slots

    n = alive.shape[0]
    send_l, valid_l, ov_l, take_l = _pack(arrays, alive & go_left, capacity,
                                          with_take=True)
    send_r, valid_r, ov_r, take_r = _pack(arrays, alive & go_right, capacity,
                                          with_take=True)
    stay = alive & ~(go_left | go_right)
    for take, valid in ((take_l, valid_l), (take_r, valid_r)):
        t_of = tile_id[take].to(torch.int64)
        free_idx, free_cnt = push_slots(free_idx, free_cnt, take, t_of,
                                        valid & (t_of < n_tiles))
        spare_idx, spare_cnt = push_slots(
            spare_idx, spare_cnt, take, torch.zeros_like(t_of),
            valid & (t_of >= n_tiles))
    arrivals, arrivals_valid = _exchange(send_l, valid_l, send_r, valid_r,
                                         group)

    # seat the arrivals: their tile's stack first, the spare stack for the
    # rest
    arr_tiles = arrival_tiles_fn(arrivals)
    slot, got, free_idx, free_cnt = pop_slots(free_idx, free_cnt, arr_tiles,
                                              arrivals_valid, n)
    slot2, got2, spare_idx, spare_cnt = pop_slots(
        spare_idx, spare_cnt, torch.zeros_like(arr_tiles),
        arrivals_valid & ~got, n)
    placed = got | got2
    dest = torch.where(placed, torch.where(got, slot, slot2), n)
    out = tuple(_set_drop(a, dest, arr) for a, arr in zip(arrays, arrivals))
    new_alive = _set_drop(stay, dest, torch.ones_like(placed))
    n_lost = (arrivals_valid & ~placed).sum()
    return StackedMigrationResult(
        arrays=out, alive=new_alive, overflow=ov_l + ov_r + n_lost,
        free_idx=free_idx, free_cnt=free_cnt, spare_idx=spare_idx,
        spare_cnt=spare_cnt, placed_tile=got.sum(), placed_spare=got2.sum())


def migrate_grid(arrays: tuple, alive: torch.Tensor, mask_fn, groups,
                 capacity: int) -> MigrationResult:
    """Dimension-ordered migration over a multi-axis spatial mesh: one
    ``migrate_ring`` phase per axis (``groups``: the axes' process
    groups), in order, so a diagonal mover routes in two hops.
    ``mask_fn(arrays, k)`` is called at the start of phase ``k`` with the
    current arrays (phase 1 sees phase 0's arrivals) and returns ``(go_lo,
    go_hi)`` for that axis.  Returns the summed overflow of the phases."""
    res = MigrationResult(tuple(arrays), alive,
                          torch.zeros((), dtype=torch.int64,
                                      device=alive.device))
    for k, group in enumerate(groups):
        go_lo, go_hi = mask_fn(res.arrays, k)
        r = migrate_ring(res.arrays, res.alive, go_lo, go_hi, group,
                         capacity)
        res = MigrationResult(r.arrays, r.alive, res.overflow + r.overflow)
    return res
