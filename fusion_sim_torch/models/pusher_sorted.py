"""Tile-sorted path of the grid-parity cylindrical pusher (port of
``fusion_sim_tpu/models/pusher_sorted.py``).

The particles live permanently in the padded tile-sorted layout of
ops/sorted_deposit, so both per-particle samplings of a half-step — the 12
coefficient channels at the particle's cell (empic.js:749-773) and the
sink mask at the drifted cell (empic.js:712-720) — read one small tile
window per block.  Rows that leave their window are re-pushed exactly
through a compacted patch (up to ``spill_capacity`` a substep).  Backends:

* ``'xla'``    — ``gather_sorted_2d`` (plain PyTorch) for both samplings;
* ``'pallas'`` — the windowed gather kernel B3 (ops/sorted_gather.py);
* ``'fused'``  — one kernel B2 per half-step covering gather, rotation,
  drift and sink sample (ops/fused_pusher.py).

Per particle the physics is that of the plain grid path; only the gather
route and the row order differ.  ``repair=True`` relocates every substep
the rows whose final sample cell left their block's window (margin
out-drifters and fresh respawns) into dead slots of their new tile
(ops/repair.py), so the full resort runs only when the free stacks drain.
Filler rows sit frozen at FILLER (r = z = 0.5, away from the r = 0
direction singularity) with weight 0.

The step functions take this step's two substep uniforms as an argument
(the shell draws them from its generator), so a caller can replay another
package's random numbers row for row.  Where the reference runs
``lax.cond``/``lax.scan``, the port reads counts on the host: each
substep reads its spill count(s) and its respawn count once.  Counters
(``spill``, ``dropped``, ``dropped_over``) are Python ints.

A step's operations fall in the leaf spans of ``utils/profiling.span`` (a
profiler's annotations while one records, else the host clock's phases):
``kernel`` (the coefficient table and the substep's sampling and push),
``patch`` (the spill masks, counts, compaction and exact re-push),
``respawn`` (the sink values and ``ops/push.sink_respawn``), ``finish``
(repair and the fillers' ``where``), with ``host_read`` around each count
read; the counter ``rows_patched`` adds min(spill, capacity) a sample, and
``sink_respawn`` counts ``rows_respawned``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import device_const, resolve_device
from ..ops.boris import gather_nearest, pack_coefficients, velocity_from_rows
from ..ops.deposit import deposit_moments, ema_moments, normalize_moments
from ..ops.fused_pusher import cell_coords as _cell_coords
from ..ops.fused_pusher import fused_pusher_substep
from ..ops.interp import patch_rows, spill_rows
from ..ops.push import sink_respawn
from ..ops.repair import allocate_slots, relocate
from ..ops.sorted_deposit import (Tiling2D, build_padded_layout,
                                  gather_sorted_2d, tile_ids)
from ..ops.sorted_gather import gather_sorted_2d_window
from ..utils.profiling import count, span
from ..utils.render import render_bmag, render_density_overlay

FILLER = (0.5, 0.0, 0.5)
BACKENDS = ("xla", "pallas", "fused")


class SortedPusherState(NamedTuple):
    position: torch.Tensor     # (Np, 3) normalized Cartesian (fillers: FILLER)
    velocity: torch.Tensor     # (Np, 3)
    alive: torch.Tensor        # (Np,) the w flag (fillers: 1 = inert)
    valid: torch.Tensor        # (Np,) bool — False on filler rows
    tile_id: torch.Tensor      # (Np,) int32, (r, z)-cell tile at last resort
    moments_avg: torch.Tensor  # (nr, nz, 4)
    spill: int = 0             # cumulative exact-patched rows
    dropped: int = 0           # cumulative respawns past respawn_capacity
    dropped_over: int = 0      # cumulative out-of-window rows past
                               # spill_capacity (frozen that substep)
    # incremental layout repair (repair=True) only:
    free_idx: torch.Tensor | None = None  # (n_tiles, F) dead-slot stacks
    free_cnt: torch.Tensor | None = None  # (n_tiles,)
    unplaced: torch.Tensor | None = None  # cumulative rows left in place


def sorted_pusher_state_from_numpy(blob: dict, device=None
                                   ) -> SortedPusherState:
    """A ``SortedPusherState`` from the reference's sorted state as numpy
    arrays (``{k: np.asarray(v) for k, v in jax_sim._sorted_state
    ._asdict().items() if v is not None}``), so both packages can start
    from one layout.  The reference's ``key`` is read and ignored: it
    cannot become a torch generator state."""
    dev = resolve_device(device)

    def t(key, dtype):
        if blob.get(key) is None:
            return None
        return torch.tensor(np.asarray(blob[key], dtype), device=dev)

    def count(key):
        value = blob.get(key)
        return 0 if value is None else int(np.asarray(value))

    return SortedPusherState(
        position=t("position", np.float32), velocity=t("velocity", np.float32),
        alive=t("alive", np.float32), valid=t("valid", np.bool_),
        tile_id=t("tile_id", np.int32),
        moments_avg=t("moments_avg", np.float32), spill=count("spill"),
        dropped=count("dropped"), dropped_over=count("dropped_over"),
        free_idx=t("free_idx", np.int64), free_cnt=t("free_cnt", np.int64),
        unplaced=t("unplaced", np.int64))


def padded_size(spec, tiling: Tiling2D) -> int:
    """Layout length: the real count rounded up to the block, plus one
    block of padding budget per tile."""
    n_tiles = math.prod(tiling.n_tiles((spec.nr, spec.nz)))
    n0 = -(-spec.n_total // tiling.block) * tiling.block
    return n0 + n_tiles * tiling.block


def _relocate_out_rows(state: SortedPusherState, position, velocity, alive,
                       nr: int, nz: int, tiling: Tiling2D,
                       spill_capacity: int):
    """The repair pass of every backend: rows whose FINAL sample cell left
    their block's window (margin out-drifters and fresh respawns, the
    pusher's main layout churn), up to ``spill_capacity`` in row order, are
    relocated into dead slots of their new tile.  Unplaced rows stay, keep
    taking the exact patch and retry next substep.  Returns ``(position,
    velocity, alive, valid, state updates)``; the three arrays are updated
    in place."""
    n_tot = position.shape[0]
    n_tiles = math.prod(tiling.n_tiles((nr, nz)))
    ntz = tiling.n_tiles((nr, nz))[1]
    m = tiling.margin
    wr, wz = tiling.window()
    cell = _cell_coords(position, nr, nz)
    tid = state.tile_id.to(torch.int64)
    org_r = (torch.div(tid, ntz, rounding_mode="floor") * tiling.tile_r
             - m).to(torch.float32)
    org_z = (torch.remainder(tid, ntz) * tiling.tile_z - m).to(torch.float32)
    lr = torch.remainder(cell[:, 0] - org_r, nr)
    lz = torch.remainder(cell[:, 1] - org_z, nz)
    mask = ((lr >= float(wr - 1)) | (lz >= float(wz - 1))) & state.valid
    idx = spill_rows(mask, mask.sum(), spill_capacity, n_tot)[0]
    at = torch.clamp(idx, max=n_tot - 1)
    dest, placed, fidx, fcnt, nun = allocate_slots(
        state.free_idx, state.free_cnt, idx, idx < n_tot,
        tile_ids(cell[at], (nr, nz), tiling), tid[at], n_tot, n_tiles)
    (position, velocity, alive), valid = relocate(
        (position, velocity, alive), state.valid, idx, dest, placed,
        (position[at], velocity[at], alive[at]), n_tot)
    return position, velocity, alive, valid, dict(
        free_idx=fidx, free_cnt=fcnt, unplaced=state.unplaced + nun)


def make_sorted_resort_fn(spec, tiling: Tiling2D, reserve: bool = False):
    """``state -> state``: rebuild the layout from the sample cells (one
    sort); fillers and invalid rows sink to the trailing dead region.
    ``reserve`` lays out every tile with dead slots spread over the tiles
    (``build_padded_layout(reserve=, spread=)``), as repair needs."""
    nr, nz = spec.nr, spec.nz

    def resort(state: SortedPusherState) -> SortedPusherState:
        n_state = state.position.shape[0]
        cell = _cell_coords(state.position, nr, nz)
        out = build_padded_layout(
            cell, (nr, nz), tiling, state.position, state.velocity,
            state.alive, valid=state.valid, reserve=reserve, spread=reserve,
            derive_valid=True)
        tid, _, pos, vel, alive, valid = (t[:n_state] for t in out[:-1])
        keep = valid[:, None]
        filler = device_const(FILLER, pos.device)
        return state._replace(
            position=torch.where(keep, pos, filler),
            velocity=torch.where(keep, vel, 0.0),
            alive=torch.where(valid, alive, 1.0),
            valid=valid, tile_id=tid)

    return resort


def _radius(position: torch.Tensor) -> torch.Tensor:
    x, y = position[:, 0], position[:, 1]
    return torch.sqrt(x * x + y * y)


def make_sorted_step_fn(spec, tiling: Tiling2D, spill_capacity: int = 16384,
                        backend: str = "xla", repair: bool = False,
                        respawn_capacity: int | None = None,
                        spill_tiers: tuple[int, ...] = ()):
    """``step(fields, state, rands) -> state``: one full step (two
    half-steps) on the padded sorted layout; ``rands`` holds the two
    substeps' (Np, 4) uniforms, in order.

    ``respawn_capacity`` sizes the per-substep respawn compaction (``None``:
    min(spill_capacity, 2048)); its overflow counts in ``dropped`` and
    those rows stay absorbed one more substep.  Out-of-window rows past
    ``spill_capacity`` count in ``dropped_over`` and FREEZE for the substep
    on every backend.  ``spill_tiers`` (fused backend) are smaller patch
    buffers for low-spill substeps; the result is the same.  ``repair``
    relocates the rows that left their window into their new tile each
    substep (the state then carries the free stacks)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} (one of {BACKENDS})")
    if respawn_capacity is None:
        respawn_capacity = min(spill_capacity, 2048)
    nr, nz = spec.nr, spec.nz
    shape = (nr, nz)
    step_factor = float(spec.step_factor)
    caps = (*spill_tiers, spill_capacity) if backend == "fused" \
        else (spill_capacity,)

    def finish(state, position, velocity, alive, **counts):
        """Repair (relocation), then fillers frozen and inert."""
        with span("finish"):
            v = state.valid
            if repair:
                position, velocity, alive, v, extra = _relocate_out_rows(
                    state, position, velocity, alive, nr, nz, tiling,
                    spill_capacity)
                counts.update(extra, valid=v)
            return state._replace(
                position=torch.where(v[:, None], position,
                                     device_const(FILLER, position.device)),
                velocity=torch.where(v[:, None], velocity, 0.0),
                alive=torch.where(v, alive, 1.0), **counts)

    def patched(n: int) -> None:
        """Count the rows of a sample that take the patch."""
        count("rows_patched", min(n, spill_capacity))

    def window_gather(grid, cell, tile_id):
        if backend == "pallas":
            return gather_sorted_2d_window(grid, cell, tile_id, shape,
                                           tiling, mode="nearest")
        return gather_sorted_2d(grid, cell, tile_id, shape, tiling,
                                mode="nearest")

    def gather_substep(fields, state, packed, rand):
        valid = state.valid
        # velocity: windowed 12-channel NEAREST gather + exact patch
        with span("kernel"):
            cell = _cell_coords(state.position, nr, nz)
            rows, g_inw = window_gather(packed, cell, state.tile_id)
        with span("patch"):
            g_mask = ~g_inw & valid
            n_g, idx = patch_rows(g_mask, caps)
            if idx.numel():
                pk = state.position[idx]
                rows[idx] = gather_nearest(packed, _radius(pk), pk[:, 2])
        # position: drift, windowed sink sample + exact patch
        with span("kernel"):
            velocity = velocity_from_rows(state.position, state.velocity,
                                          state.alive, rand, rows)
            next_pos = state.position + step_factor * velocity
            sink_grid = fields.sink_mask[..., None]
            sink, s_inw = window_gather(
                sink_grid, _cell_coords(next_pos, nr, nz), state.tile_id)
            sink = sink[:, 0]
        with span("patch"):
            s_mask = ~s_inw & valid
            n_s, idx2 = patch_rows(s_mask, caps)
            if idx2.numel():
                pk2 = next_pos[idx2]
                sink[idx2] = gather_nearest(sink_grid, _radius(pk2),
                                            pk2[:, 2])[:, 0]
            patched(n_g)
            patched(n_s)
        with span("respawn"):
            sink = torch.where(valid, sink, 1.0)
            # patch overflow: rows past spill_capacity were not patched, so
            # their samples are wrong; they FREEZE for this substep (no
            # move, no absorb/respawn) and retry
            frozen = None
            if max(n_g, n_s) > spill_capacity:
                patched_g = torch.zeros_like(valid)
                patched_g[idx] = True
                patched_s = torch.zeros_like(valid)
                patched_s[idx2] = True
                frozen = (g_mask & ~patched_g) | (s_mask & ~patched_s)
                sink = torch.where(frozen, 1.0, sink)
            position, alive, n_drop = sink_respawn(
                next_pos, sink, rand, fields.inv_cdf,
                respawn_capacity=respawn_capacity)
            if frozen is not None:
                position = torch.where(frozen[:, None], state.position,
                                       position)
                velocity = torch.where(frozen[:, None], state.velocity,
                                       velocity)
                alive = torch.where(frozen, state.alive, alive)
        n_over = (max(n_g - spill_capacity, 0)
                  + max(n_s - spill_capacity, 0))
        return finish(state, position, velocity, alive,
                      spill=state.spill + n_g + n_s,
                      dropped=state.dropped + n_drop,
                      dropped_over=state.dropped_over + n_over)

    def fused_substep(fields, state, packed13, rand):
        with span("kernel"):
            pos1, vel1, sink, inw = fused_pusher_substep(
                packed13, state.position, state.velocity, state.alive, rand,
                state.tile_id, nr, nz, tiling, step_factor)
        # exact re-push of the out-of-window rows (the kernel froze them);
        # rows past spill_capacity stay frozen with sink = 1
        with span("patch"):
            mask = ~inw & state.valid
            n_sp, idx = patch_rows(mask, caps)
            if idx.numel():
                pk = state.position[idx]
                rows_k = gather_nearest(packed13[..., :12], _radius(pk),
                                        pk[:, 2])
                vel_k = velocity_from_rows(pk, state.velocity[idx],
                                           state.alive[idx], rand[idx],
                                           rows_k)
                pos_k = pk + step_factor * vel_k
                pos1[idx] = pos_k
                vel1[idx] = vel_k
                sink[idx] = gather_nearest(packed13[..., 12:13],
                                           _radius(pos_k), pos_k[:, 2])[:, 0]
            patched(n_sp)
        with span("respawn"):
            sink = torch.where(state.valid, sink, 1.0)
            position, alive, n_drop = sink_respawn(
                pos1, sink, rand, fields.inv_cdf,
                respawn_capacity=respawn_capacity)
        return finish(state, position, vel1, alive,
                      spill=state.spill + n_sp,
                      dropped=state.dropped + n_drop,
                      dropped_over=(state.dropped_over
                                    + max(n_sp - spill_capacity, 0)))

    def step(fields, state: SortedPusherState, rands) -> SortedPusherState:
        with span("kernel"):
            packed = pack_coefficients(fields.coeffs)
            substep = gather_substep
            if backend == "fused":
                packed = torch.cat([packed, fields.sink_mask[..., None]],
                                   dim=-1)
                substep = fused_substep
        for rand in rands:
            state = substep(fields, state, packed, rand)
        return state

    return step


def make_sorted_density_fn(spec):
    """``density(fields, state) -> (state, frame)`` over the padded layout
    (filler weight 0)."""

    def density(fields, state: SortedPusherState):
        moments = deposit_moments(state.position, state.velocity, spec.nr,
                                  spec.nz,
                                  weights=state.valid.to(torch.float32))
        avg = ema_moments(normalize_moments(moments), state.moments_avg)
        frame = render_density_overlay(render_bmag(fields.b), avg)
        return state._replace(moments_avg=avg), frame

    return density


def to_sorted_state(state, spec, tiling: Tiling2D,
                    reserve: bool = False) -> SortedPusherState:
    """A plain ``PusherState`` -> the padded sorted layout (row order not
    preserved); ``reserve`` as ``make_sorted_resort_fn``'s."""
    n = spec.n_total
    n_p = padded_size(spec, tiling)
    n0 = -(-n // tiling.block) * tiling.block
    dev = state.position.device
    f32 = torch.float32

    def pad(a, fill, dead):
        # rows n..n0 pad to the block (invalid, any value); rows n0..n_p
        # are the fillers
        tail = (n0 - n,) + tuple(a.shape[1:])
        return torch.cat([a, torch.full(tail, fill, dtype=f32, device=dev),
                          dead])

    base = SortedPusherState(
        position=pad(state.position, 0.0,
                     device_const(FILLER, dev).expand(n_p - n0, 3)),
        velocity=pad(state.velocity, 0.0,
                     torch.zeros((n_p - n0, 3), dtype=f32, device=dev)),
        alive=pad(state.alive, 1.0,
                  torch.ones((n_p - n0,), dtype=f32, device=dev)),
        valid=torch.arange(n_p, device=dev) < n,
        tile_id=torch.zeros((n_p,), dtype=torch.int32, device=dev),
        moments_avg=state.moments_avg)
    return make_sorted_resort_fn(spec, tiling, reserve=reserve)(base)


def from_sorted_state(sorted_state: SortedPusherState, spec, state_cls):
    """The padded sorted layout -> a plain state (live rows, layout
    order)."""
    order = torch.argsort((~sorted_state.valid).to(torch.uint8),
                          stable=True)[:spec.n_total]
    return state_cls(position=sorted_state.position[order],
                     velocity=sorted_state.velocity[order],
                     alive=sorted_state.alive[order],
                     moments_avg=sorted_state.moments_avg)
