"""Incremental per-tile layout repair for the sorted layouts (port of
``fusion_sim_tpu/ops/repair.py``, single device).

The tile-sorted layouts (``ops/sorted_deposit.build_padded_layout``) decay
as particles drift: rows that leave their block's window fall onto the
exact spill patch every step until a full resort rebuilds the layout.
Repair removes the cadence: every step the (compacted) spilled rows are
relocated into dead filler slots of blocks of their NEW tile.  In flows
near equilibrium, departures free the slots arrivals need, so the full
resort runs only when a tile's inventory drains.

Data structure: a per-tile stack of dead-slot indices,

    free_idx: (n_tiles, F) int64   slot row indices (sentinel-padded)
    free_cnt: (n_tiles,)   int64   live stack depth (<= F)

kept on the device.  Layout invariants (from ``build_padded_layout``): rows
are tile-contiguous in block units, and a dead slot of tile t's segment
stays in tile t (repair flips valid flags and writes payloads; tile ids
change only at a resort).

Every function runs on the device without a host read: the reference's
``jax.ops.segment_sum`` and scatters with ``mode='drop'`` become
``index_add_``/``index_put_`` with out-of-range entries sent to a spare
bucket, and its sorts are stable ``torch.argsort``es (``jnp.argsort`` is
stable too), so slot assignment follows the reference row for row.  The
reference clamps out-of-range gather indices; the port clamps them
explicitly.  The sharded functions (``sharded_repair_migrate``,
``init_spare_list``, ``make_sharded_free_init``) come with the sharded
models (ROADMAP Queue A 11).
"""

from __future__ import annotations

import math
import warnings

import torch

from .interp import spill_rows
from .sorted_deposit import tile_ids, tile_ids_3d


def _segment_sum(values: torch.Tensor, ids: torch.Tensor,
                 num: int) -> torch.Tensor:
    """Sum of ``values`` per id in [0, num); other ids are dropped (the
    reference's ``segment_sum(num_segments=num)``), with no host read."""
    out = torch.zeros(num + 1, dtype=torch.int64, device=values.device)
    out.index_add_(0, torch.clamp(ids, 0, num), values.to(torch.int64))
    return out[:num]


def init_free_list(tile_id: torch.Tensor, valid: torch.Tensor, n_tiles: int,
                   block: int, capacity: int, spare: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile dead-slot stacks of a FRESH layout (straight out of
    ``build_padded_layout``, where each tile segment's dead rows are a
    contiguous suffix, so the stack is a range).  Tiles with more than
    ``capacity`` fillers track the first ``capacity``.

    ``spare=True`` adds one stack row (index ``n_tiles``) over the trailing
    dead region (rows with ``tile_id == n_tiles``).  Returns ``(free_idx
    (rows, capacity), free_cnt (rows,))``, int64, ``rows = n_tiles +
    spare``."""
    n = tile_id.shape[0]
    dev = tile_id.device
    rows = n_tiles + (1 if spare else 0)
    blk_tile = tile_id[::block].to(torch.int64).contiguous()
    bounds = torch.searchsorted(
        blk_tile, torch.arange(rows + 1, device=dev)) * block
    tid = tile_id.to(torch.int64)
    dead = ~valid & (tid < rows)
    dead_per_tile = _segment_sum(dead, tid, rows)
    cnt = torch.clamp(dead_per_tile, max=capacity)
    k = torch.arange(capacity, device=dev)
    start = bounds[1:] - dead_per_tile
    free_idx = torch.where(k[None, :] < cnt[:, None],
                           start[:, None] + k[None, :], n)
    return free_idx, cnt


def near_band_mask(position: torch.Tensor, tile_id: torch.Tensor,
                   shape: tuple, tiling, keep: int) -> torch.Tensor:
    """Rows that have used all but ``keep`` cells of their sort margin:
    True where any axis of ``position`` lies more than ``margin - keep``
    cells outside the row's ASSIGNED tile (periodic wrap) — still inside
    the block window, but within ``keep`` cells of leaving it.  Eager
    repair relocates these rows while their kernel outputs are still exact,
    so with per-step displacement < ``keep`` cells no window exit ever
    needs the patch."""
    nd = len(shape)
    nts = tiling.n_tiles(shape)
    tid = torch.clamp(tile_id.to(torch.int64), max=math.prod(nts) - 1)
    if nd == 2:
        tiles = (tiling.tile_r, tiling.tile_z)
        axes = (torch.div(tid, nts[1], rounding_mode="floor"),
                torch.remainder(tid, nts[1]))
    else:
        tiles = tiling.tile
        plane = nts[1] * nts[2]
        rem = torch.remainder(tid, plane)
        axes = (torch.div(tid, plane, rounding_mode="floor"),
                torch.div(rem, nts[2], rounding_mode="floor"),
                torch.remainder(rem, nts[2]))
    slack = tiling.margin - keep
    if slack < 0:
        raise ValueError(f"keep={keep} exceeds margin={tiling.margin}")
    out = None
    for a in range(nd):
        lo = axes[a].to(torch.float32) * tiles[a] - slack
        rel = torch.remainder(position[:, a] - lo, float(shape[a]))
        o = rel >= tiles[a] + 2 * slack
        out = o if out is None else out | o
    return out


def _segment_ranks(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal (sorted) keys."""
    first = torch.searchsorted(keys, keys, side="left")
    return torch.arange(keys.shape[0], device=keys.device) - first


def pop_slots(free_idx: torch.Tensor, free_cnt: torch.Tensor,
              tiles: torch.Tensor, want: torch.Tensor, n_total: int):
    """Pop one dead slot per requested row from stack row ``tiles[k]``
    (any value >= the stack row count means no request, like
    ``want=False``).  Returns ``(slot (K,), got (K,) bool, free_idx,
    free_cnt')``; unsatisfied requests come back ``got=False, slot=n_total``.
    """
    rows, cap = free_idx.shape
    key = torch.where(want, torch.clamp(tiles.to(torch.int64), max=rows),
                      rows)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    ok_s = key_s < rows
    r = _segment_ranks(key_s)
    t_c = torch.clamp(key_s, max=rows - 1)
    cnt_t = free_cnt[t_c]
    got_s = ok_s & (r < cnt_t)
    slot_s = free_idx[t_c, torch.clamp(cnt_t - 1 - r, 0, cap - 1)]
    slot_s = torch.where(got_s, slot_s, n_total)
    free_cnt = free_cnt - _segment_sum(got_s, key_s, rows)
    inv = torch.argsort(order)
    return slot_s[inv], got_s[inv], free_idx, free_cnt


def push_slots(free_idx: torch.Tensor, free_cnt: torch.Tensor,
               slots: torch.Tensor, tiles: torch.Tensor, ok: torch.Tensor):
    """Push freed slot indices onto per-tile stacks (``slots``/``tiles``/
    ``ok``: (K,) slot rows, their stack row, a validity mask).  Pushes past
    a stack's capacity are dropped (the slot leaks until the next full
    resort).  Returns ``(free_idx', free_cnt')``."""
    rows, cap = free_idx.shape
    key = torch.where(ok, torch.clamp(tiles.to(torch.int64), max=rows), rows)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    slots_s = slots[order].to(free_idx.dtype)
    r = _segment_ranks(key_s)
    t_c = torch.clamp(key_s, max=rows - 1)
    pos = free_cnt[t_c] + r
    write_ok = (key_s < rows) & (pos < cap)
    # dropped writes go to a spare row (the reference's mode='drop')
    padded = torch.cat([free_idx, free_idx[:1]])
    padded[torch.where(write_ok, t_c, rows),
           torch.clamp(pos, 0, cap - 1)] = slots_s
    return padded[:rows], free_cnt + _segment_sum(write_ok, key_s, rows)


def allocate_slots(free_idx: torch.Tensor, free_cnt: torch.Tensor,
                   src: torch.Tensor, ok: torch.Tensor,
                   new_tile: torch.Tensor, old_tile: torch.Tensor,
                   n_total: int, n_tiles: int, rounds: int = 2):
    """Assign each spilled row a dead slot in its new tile (pop), and free
    the source slots of relocated rows for later arrivals (push).

    ``src``: (K,) compacted spilled-row indices (sentinel ``n_total`` on
    unused entries); ``ok``: (K,) validity; ``new_tile``/``old_tile``: (K,)
    tile of the row's new position / of its current block.  With
    ``rounds >= 2`` an arrival can take a slot freed by a departure in the
    same call.  Returns ``(dest (K,), placed (K,) bool, free_idx',
    free_cnt', n_unplaced)``; ``dest == src`` where no slot was free (the
    row stays, keeps its exact patch, and retries next step)."""
    dest = src.to(torch.int64)
    placed = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
    for _ in range(rounds):
        slot, got, free_idx, free_cnt = pop_slots(
            free_idx, free_cnt, new_tile, ok & ~placed, n_total)
        dest = torch.where(got, slot, dest)
        placed = placed | got
        # rows leaving trailing (old_tile >= n_tiles) slots push nothing
        free_idx, free_cnt = push_slots(free_idx, free_cnt, src, old_tile,
                                        got)
    n_unplaced = (ok & ~placed).sum()
    return dest, placed, free_idx, free_cnt, n_unplaced


def _put(a: torch.Tensor, index: torch.Tensor, values: torch.Tensor,
         mask: torch.Tensor) -> None:
    """``a[index[mask]] = values[mask]`` in place with no host read:
    unmasked entries repeat the first masked write (or rewrite row 0 with
    itself when nothing is masked), so no index gets two different values.
    """
    if not index.numel():
        return
    first = torch.argmax(mask.to(torch.int32))
    some = mask.any()
    at = torch.where(mask, index, torch.where(some, index[first], 0))
    fill = torch.where(some, values[first], a[0].to(values.dtype))
    shaped = mask.reshape((-1,) + (1,) * (values.dim() - 1))
    a[at] = torch.where(shaped, values, fill).to(a.dtype)


def relocate(arrays, valid: torch.Tensor, src: torch.Tensor,
             dest: torch.Tensor, placed: torch.Tensor, values,
             n_total: int):
    """Move rows ``src -> dest``: payload ``values`` (matching (K, ...)
    new values) written at ``dest`` (``dest == src`` for unplaced rows);
    entries at the sentinel ``n_total`` are dropped.  Returns ``(arrays',
    valid')``; the arrays are updated in place, ``valid`` is copied."""
    keep = dest < n_total
    for a, v in zip(arrays, values):
        _put(a, dest, v, keep)
    valid = valid.clone()
    n = placed.shape[0]
    _put(valid, src, torch.zeros(n, dtype=torch.bool, device=valid.device),
         placed & (src < n_total))
    _put(valid, dest, torch.ones(n, dtype=torch.bool, device=valid.device),
         placed)
    return tuple(arrays), valid


def repair_relocate(state, x1, velocity, idx, ok, pos_k, vel_k, shape,
                    tiling, n_tiles: int, ndim: int, in_win=None,
                    eager_keep: int = 0, eager_cap: int = 0):
    """The repair step of the single-device sorted models (ES and EM):
    relocate the compacted spilled rows ``idx`` (exact values ``pos_k``/
    ``vel_k``) into dead slots of their new tile, then, with ``eager_keep >
    0`` and ``in_win`` the step's in-window mask, also relocate rows within
    ``eager_keep`` cells of leaving their window, carrying their own values.
    ``idx`` None means no row was patched (then, without eager, nothing
    moves: the reference's zero-request pass changes nothing either);
    ``ok`` None means every entry of ``idx`` is a row.

    ``state`` needs ``free_idx``/``free_cnt``/``valid``/``tile_id``/
    ``unplaced`` (a device count).  Band rows beyond ``eager_cap`` wait for
    the next step and count into ``unplaced`` (not lost: still in their
    window).  Returns ``(x1, velocity, valid, extra)`` with ``extra`` the
    state updates; ``x1`` and ``velocity`` are updated in place."""
    if idx is None:
        if not eager_keep:
            return x1, velocity, state.valid, {}
        idx = torch.empty((0,), dtype=torch.int64, device=x1.device)
        pos_k, vel_k = x1[:0], velocity[:0]
    if ok is None:
        ok = torch.ones(idx.shape, dtype=torch.bool, device=x1.device)
    n_tot = x1.shape[0]
    tid_fn = tile_ids if ndim == 2 else tile_ids_3d
    tile_id = state.tile_id.to(torch.int64)
    at = torch.clamp(idx, max=n_tot - 1)
    dest, placed, fidx, fcnt, nun = allocate_slots(
        state.free_idx, state.free_cnt, idx, ok, tid_fn(pos_k, shape, tiling),
        tile_id[at], n_tot, n_tiles)
    (x1, velocity), valid = relocate((x1, velocity), state.valid, idx, dest,
                                     placed, (pos_k, vel_k), n_tot)
    if eager_keep:
        grid_f = torch.tensor(shape, dtype=torch.float32, device=x1.device)
        mask_e = in_win & valid & near_band_mask(x1, state.tile_id, shape,
                                                 tiling, eager_keep)
        n_band = mask_e.sum()
        idx_e = spill_rows(mask_e, n_band, eager_cap, n_tot)[0]
        ok_e = idx_e < n_tot
        at_e = torch.clamp(idx_e, max=n_tot - 1)
        x_e, v_e = x1[at_e], velocity[at_e]
        dest_e, placed_e, fidx, fcnt, nun_e = allocate_slots(
            fidx, fcnt, idx_e, ok_e,
            tid_fn(torch.remainder(x_e, grid_f), shape, tiling),
            tile_id[at_e], n_tot, n_tiles)
        (x1, velocity), valid = relocate((x1, velocity), valid, idx_e,
                                         dest_e, placed_e, (x_e, v_e), n_tot)
        # deferred band rows retry next step; surfaced so an undersized
        # buffer is observable
        nun = nun + nun_e + torch.clamp(n_band - eager_cap, min=0)
    extra = dict(free_idx=fidx, free_cnt=fcnt, valid=valid,
                 unplaced=state.unplaced + nun)
    return x1, velocity, valid, extra


def drain_check(state, unplaced_seen: int, overflow_seen: int,
                spill_capacity: int, per_shard_capacity: int,
                n_steps: int):
    """The resort-on-drain rule of the repair shells, read on the host once
    a ``step()`` call: a full resort is due when ``unplaced`` grew by more
    than max(64, min(capacities) // 8) a step since the last check
    (relocations found their tile's stack empty), or when ``overflow``
    (migration arrivals dropped, the sharded shells) grew at all.  ``state``
    needs ``unplaced``; ``overflow`` counts as 0 where it has none.
    Returns ``(need_resort, unplaced_seen', overflow_seen')``."""
    unplaced = int(torch.as_tensor(state.unplaced).sum())
    ovf = getattr(state, "overflow", None)
    overflow = 0 if ovf is None else int(torch.as_tensor(ovf).sum())
    d_unpl = unplaced - unplaced_seen
    d_ovf = overflow - overflow_seen
    need = d_unpl > max(64, min(spill_capacity,
                                per_shard_capacity) // 8) * max(1, n_steps)
    if d_ovf > 0:
        warnings.warn(
            f"{d_ovf} migration arrivals were dropped (their tile's free "
            f"stack AND the spare stack were empty); scheduling a full "
            f"resort — raise spare_slots/repair_free_slots or lower the "
            f"resort threshold to avoid the loss",
            RuntimeWarning, stacklevel=3)
        need = True
    return need, unplaced, overflow
