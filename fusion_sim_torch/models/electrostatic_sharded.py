"""Spatially decomposed electrostatic PIC with a distributed field solve
(port of ``fusion_sim_tpu/models/electrostatic_sharded.py``).

The grid splits into x-slabs, one a rank of a process group (the ring);
each rank owns the particles inside its slab, in fixed-capacity slots
with dead-slot masking.  One step, all on the rank's own shard:

    deposit (CIC, apron fold)  ->  all_reduce-neutralized rho
    -> distributed Poisson solve  ->  E = -grad(phi) (halo'd central diff)
    -> gather (halo'd CIC)     ->  kick/drift    ->  ring migration

The reference runs this inside ``shard_map``; the port runs one process a
rank (``torchrun``, ``torch.multiprocessing``, or a world of one that
``parallel.mesh.make_mesh`` starts) with explicit collectives: the apron
fold and halos are paired point-to-point messages (``parallel/halo``),
migration is ``parallel/migration``, the solve is an ``all_gather`` and a
replicated dense-DFT solve (2D grids up to ``GATHERED_DFT_MAX``, the
reference's route) or the pencil ``poisson_fft_sharded``.

The sorted compositions (a ``tiling``) keep each rank's particles in the
padded tile-sorted layout of a halo-padded pseudo-grid (the slab plus
``halo_w`` cells on each side, the rest of the grid whole).  With
``backend='pallas'`` one fused kernel a step does each rank's gather +
kick + drift + deposit on that pseudo-grid: kernel B1
(``ops/fused_pic.fused_es2d_substep``) in 2D and B5
(``ops/fused_pic3d.fused_es3d_substep``) in 3D, the same kernels as the
single-device model.  The x axis of the pseudo-grid is not periodic: rows
live in the slab, whose windows reach into the halos; the kernels' window
wrap on the pseudo-grid reads only halo cells there.  In 3D the resort
orders each tile's rows by cell, as the single-device 3D shell does, so
B5 takes its warp-combined deposit.  ``repair=True`` relocates spilled
rows into their new tile every step and seats migration arrivals straight
into their tile's segment (``ops/repair.sharded_repair_migrate``).

A rank's state (``ShardedESState``) holds its own shard: the reference's
global (n_shards * capacity, ...) arrays are the ranks' states stacked.
``gather_particles`` and ``check_invariants`` gather over the ring.  Per
step the particles may move less than ``disp_bound`` cells (half a slab
for the migration masks, APRON_W - 1 for the apron); ``max_disp`` tracks
the largest move seen, and ``debug_checks`` raises when it breaks.

The shells open the program's phase spans (``utils/profiling.span``):
``fusion_sim.step`` around each public ``step`` and ``.resort`` around
each resort; the ES steps ``.solve`` (the neutralization, the Poisson
solve with the pencil's two transposes, the gradient) and ``.halo`` (the
apron fold, the phi and E halos); the fused step besides ``.kernel`` (the
kernel and its arguments), ``.patch`` (the spill mask and count, the
exact re-push and deposit, the spill account) and ``.migrate`` (the wrap
back to global units, the migration masks, pack, exchange and seating).
While a profiler records, ``rows_patched`` counts the rows patched and
``rows_migrated`` the rows that left the slab over either face, counted
on the device (a ring of one wraps them onto its own opposite face).

Every entry point runs on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import device_const, resolve_device
from ..ops.fused_pic import fused_es2d_substep
from ..ops.fused_pic3d import fused_es3d_substep
from ..ops.interp import cic_deposit_packed, cic_gather_packed, patch_rows
from ..ops.precision import f32_matmul, resolve_precision
from ..ops.repair import drain_check, make_sharded_free_init
from ..ops.repair import sharded_repair_migrate
from ..ops.solvers import poisson_dft2d, poisson_fft_sharded
from ..ops.sorted_deposit import (build_padded_layout, deposit_sorted_2d,
                                  deposit_sorted_3d, gather_sorted_2d,
                                  gather_sorted_3d, tile_ids, tile_ids_3d)
from ..parallel import halo, migration
from ..parallel.mesh import all_gather_rows, axis_group
from ..utils.profiling import count, span
from ..utils.stepping import make_multi_step, make_window_step, pow2_chunk
from .electrostatic import ESConfig

HALO_W = 2   # gather halo: CIC corner +1, plus 1 cell of slack
APRON_W = 2  # deposition apron: CIC corner +1, plus 1 cell of slack

# 2D grids up to this size solve by an all_gather and the dense-DFT solve
# on every rank (the reference's route: on its TPU the matmuls beat the
# emulated FFT of the pencil path); larger 2D grids and every 3D grid take
# the pencil decomposition.
GATHERED_DFT_MAX = 1024


def _use_gathered_dft(base: ESConfig) -> bool:
    return base.n_dim == 2 and max(base.grid_shape) <= GATHERED_DFT_MAX


def _phi_full_gathered(rho_local: torch.Tensor, base: ESConfig,
                       group) -> torch.Tensor:
    """The whole domain's phi on every rank: all_gather the x-slabs of rho
    and run the dense-DFT solve (ops/solvers.poisson_dft2d) replicated."""
    rho_full = all_gather_rows(rho_local, group)
    with f32_matmul():
        return poisson_dft2d(rho_full, base.cell_size, eps0=base.eps0)


@functools.lru_cache(maxsize=16)
def _window_rows(nx: int, x_lo: int, width: int, slab: int, device):
    """The global x rows of a shard's halo-padded window, and of their
    upper and lower neighbours (periodic), made once."""
    rows = torch.remainder(torch.arange(slab + 2 * width, device=device)
                           - width + x_lo, nx)
    return rows, torch.remainder(rows + 1, nx), torch.remainder(rows - 1, nx)


def _e_pad_from_full_phi(phi_full: torch.Tensor, x_lo: int, width: int,
                         slab: int, base: ESConfig) -> torch.Tensor:
    """E = -grad(phi) on the halo-padded local window, sliced from the
    replicated phi (no exchange)."""
    rows, up_rows, dn_rows = _window_rows(base.grid_shape[0], x_lo, width,
                                          slab, phi_full.device)
    up = phi_full[up_rows]
    dn = phi_full[dn_rows]
    grads = [(up - dn) / (2.0 * base.cell_size[0])]
    phi_win = phi_full[rows]
    for a in range(1, base.n_dim):
        u = torch.roll(phi_win, -1, dims=a)
        d = torch.roll(phi_win, 1, dims=a)
        grads.append((u - d) / (2.0 * base.cell_size[a]))
    return torch.stack([-g for g in grads], dim=-1)


class ShardedESState(NamedTuple):
    """One rank's shard of the reference's state (its rows of the global
    arrays; the per-shard vectors have length 1)."""

    position: torch.Tensor   # (cap, d) global grid units (dead: 0)
    velocity: torch.Tensor   # (cap, d)
    alive: torch.Tensor      # (cap,) bool
    overflow: torch.Tensor   # (1,) cumulative migration overflow
    max_disp: torch.Tensor   # (1,) max per-step displacement seen (cells)
    # sorted compositions only:
    tile_id: torch.Tensor | None = None
    spill: torch.Tensor | None = None
    # backend='pallas' only: the charge at the CURRENT positions, carried
    # (this step's solve uses last step's deposit)
    rho: torch.Tensor | None = None
    # repair=True only: the per-tile dead-slot stacks and the spare stack
    # of trailing-region slots
    free_idx: torch.Tensor | None = None   # (n_tiles, F)
    free_cnt: torch.Tensor | None = None   # (n_tiles,)
    spare_idx: torch.Tensor | None = None  # (1, S)
    spare_cnt: torch.Tensor | None = None  # (1,)
    unplaced: torch.Tensor | None = None   # (1,) cumulative
    # sorted compositions: cumulative rows past spill_capacity (their
    # deposits lost), which the reference does not count
    spill_dropped: torch.Tensor | None = None  # (1,)


@dataclasses.dataclass(frozen=True)
class ShardedESConfig:
    base: ESConfig
    n_shards: int
    capacity: int          # particle slots per shard
    migration_buffer: int  # max migrants per direction per step
    # sorted compositions (tiling != None, 2D or 3D): per-shard tile-sorted
    # padded particles on a halo-padded pseudo-grid
    tiling: object | None = None
    resort_every: int = 6
    spill_capacity: int = 16384
    # sorted compositions only: 'pallas' runs each shard's gather + kick +
    # drift + deposit in one kernel on the pseudo-grid (B1 in 2D, B5 in
    # 3D) with the carried-rho step
    backend: str = "xla"
    # the reference's matmul strategy name, validated only (the port
    # computes in f32: ops/precision.py)
    pallas_precision: str | None = None
    # sorted compositions only: incremental layout repair (ops/repair.py)
    repair: bool = False
    repair_free_slots: int = 256
    # eager relocation this many cells before a row leaves its window;
    # 0 = off
    repair_eager: int = 0
    eager_capacity: int | None = None  # band buffer; None = spill_capacity
    # spare-stack capacity; None = max(repair_free_slots,
    # 2*migration_buffer), so one step's arrivals always seat
    spare_slots: int | None = None
    # True: check the displacement bound after every step() (raises
    # RuntimeError; one gather over the ring a step() call)
    debug_checks: bool = False

    @property
    def disp_bound(self) -> float:
        """Cells a step of motion the decomposition tolerates: the
        migration masks need < slab/2, the CIC apron APRON_W - 1."""
        return min(self.slab / 2.0, float(APRON_W - 1))

    @property
    def slab(self) -> int:
        nx = self.base.grid_shape[0]
        if nx % self.n_shards:
            raise ValueError(f"nx={nx} not divisible by {self.n_shards} "
                             f"shards")
        slab = nx // self.n_shards
        if slab < 2 * APRON_W:
            raise ValueError(f"slab width {slab} < 2*apron {2 * APRON_W}")
        return slab

    @property
    def tile_x(self) -> int:
        t = self.tiling
        return t.tile_r if self.base.n_dim == 2 else t.tile[0]

    @property
    def halo_w(self) -> int:
        """The sorted compositions' halo and apron width: whole x-tiles
        covering the margin, the CIC node and APRON_W, and at least
        2*margin + 1 cells."""
        t = self.tile_x
        need = max(self.tiling.margin + 2, APRON_W)
        h = -(-need // t) * t
        if h < 2 * self.tiling.margin + 1:
            h += t
        return h

    @property
    def pseudo_shape(self) -> tuple[int, ...]:
        if self.slab % self.tile_x:
            raise ValueError(f"slab {self.slab} not divisible by x-tile "
                             f"{self.tile_x}")
        return (self.slab + 2 * self.halo_w, *self.base.grid_shape[1:])

    @property
    def cap_padded(self) -> int:
        if self.capacity % self.tiling.block:
            raise ValueError(f"capacity {self.capacity} not a multiple of "
                             f"block {self.tiling.block}")
        n_tiles = math.prod(self.tiling.n_tiles(self.pseudo_shape))
        return self.capacity + n_tiles * self.tiling.block


def distribute(config: ShardedESConfig, position: np.ndarray,
               velocity: np.ndarray, shard: int | None = None):
    """Bucket global particles into per-shard fixed-capacity slots:
    ``(pos, vel, alive)`` for all shards stacked (the reference's arrays),
    or only shard ``shard``'s block."""
    n_shards, cap, slab = config.n_shards, config.capacity, config.slab
    d = config.base.n_dim
    shards = range(n_shards) if shard is None else (shard,)
    pos = np.zeros((len(shards) * cap, d), np.float32)
    vel = np.zeros((len(shards) * cap, velocity.shape[1]), np.float32)
    alive = np.zeros((len(shards) * cap,), bool)
    owner = np.minimum((position[:, 0] // slab).astype(int), n_shards - 1)
    for k, s in enumerate(shards):
        mine = np.where(owner == s)[0]
        if len(mine) > cap:
            raise ValueError(f"shard {s}: {len(mine)} particles > capacity "
                             f"{cap}")
        pos[k * cap: k * cap + len(mine)] = position[mine]
        vel[k * cap: k * cap + len(mine)] = velocity[mine]
        alive[k * cap: k * cap + len(mine)] = True
    return pos, vel, alive


class _Ring:
    """The step functions' view of the ring: its process group, this
    rank's shard and slab origin."""

    def __init__(self, config: ShardedESConfig, mesh, axis: str):
        self.group = axis_group(mesh, axis)
        size = dist.get_world_size(self.group)
        if size != config.n_shards:
            raise ValueError(f"n_shards={config.n_shards} on a ring of "
                             f"{size} ranks")
        self.shard = dist.get_rank(self.group)
        self.x_lo = self.shard * config.slab

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.reshape(1).clone()
        dist.all_reduce(out, group=self.group)
        return out[0]


def _solve_e_pad(config: ShardedESConfig, ring: _Ring, rho_local, width):
    """E on the rank's window of ``width`` halo cells a side, from its
    rho slab, neutralized here: the gathered dense-DFT route or the pencil
    FFT with halo'd differences (the solve and the halos in spans of their
    own)."""
    base = config.base
    with span("solve"):
        rho_local = _neutralize(config, ring, rho_local)
        if _use_gathered_dft(base):
            phi_full = _phi_full_gathered(rho_local, base, ring.group)
            return _e_pad_from_full_phi(phi_full, ring.x_lo, width,
                                        config.slab, base)
        phi_local = poisson_fft_sharded(rho_local, base.grid_shape,
                                        base.cell_size, ring.group,
                                        eps0=base.eps0)
    # x by the halo'd central difference, the whole axes by rolls
    with span("halo"):
        phi_pad = halo.with_halo(phi_local, ring.group, 1)
    with span("solve"):
        grads = [(phi_pad[2:] - phi_pad[:-2]) / (2.0 * base.cell_size[0])]
        for a in range(1, base.n_dim):
            up = torch.roll(phi_local, -1, dims=a)
            dn = torch.roll(phi_local, 1, dims=a)
            grads.append((up - dn) / (2.0 * base.cell_size[a]))
        e_local = torch.stack([-g for g in grads], dim=-1)
    with span("halo"):
        return halo.with_halo(e_local, ring.group, width)


def _neutralize(config: ShardedESConfig, ring: _Ring, rho_local):
    if not config.base.neutralizing_background:
        return rho_local
    total = ring.psum(torch.sum(rho_local))
    return rho_local - total / float(math.prod(config.base.grid_shape))


def _dxv(config, device):
    return device_const(config.base.cell_size, device)


def _max_disp(config, velocity, max_disp):
    """The running max of |dt v / dx| over the rows and axes (dead rows
    carry velocity 0).  f32 rounding is monotonic, so the largest |v| of
    each axis gives the reference's per-row maximum exactly: one column
    reduction instead of a pass per operation."""
    lo, hi = torch.aminmax(velocity, dim=0)
    vmax = torch.maximum(-lo, hi)
    disp = torch.max(config.base.dt * vmax / _dxv(config, velocity.device))
    return torch.maximum(max_disp, disp)


def _to_local(config: ShardedESConfig, position, x_lo: int):
    """Global grid units -> the shard's pseudo-grid frame: x shifted by
    the slab's origin, wrapped around the slab's centre, plus the halo
    (the reference's f32 operations in its order; a shift by 0 is left
    out, which changes no value)."""
    nx = config.base.grid_shape[0]
    off = (nx - config.slab) / 2
    lx = position[:, 0]
    if x_lo:
        lx = lx - float(x_lo)
    if off:
        lx = lx + off
    lx = torch.remainder(lx, float(nx))
    if off:
        lx = lx - off
    out = position.clone()       # one contiguous copy, then the x column
    out[:, 0] = lx + config.halo_w
    return out


def _migrate_masks(config, ring, gx, alive):
    """Rows leaving the slab to the left / right neighbour (global x
    wrapped)."""
    nx, slab, x_lo = config.base.grid_shape[0], config.slab, ring.x_lo
    d_left = torch.remainder(x_lo - gx, float(nx))
    go_left = alive & (d_left > 0) & (d_left <= slab / 2)
    go_right = alive & (torch.remainder(gx - float(x_lo + slab), float(nx))
                        < slab / 2)
    return go_left, go_right


def make_sharded_es_step_fn(config: ShardedESConfig, mesh,
                            axis: str = "space"):
    """``step(state) -> state`` of the plain (unsorted) composition, on
    this rank's shard."""
    ring = _Ring(config, mesh, axis)
    base = config.base
    ndim, rest = base.n_dim, base.grid_shape[1:]
    nx, slab = base.grid_shape[0], config.slab
    dt = base.dt
    qm_dt = base.charge / base.mass * dt
    w0 = base.charge / base.cell_volume
    pad_shape = (slab + 2 * APRON_W, *rest)
    halo_shape = (slab + 2 * HALO_W, *rest)

    def shift_x(pos, offset):
        return torch.cat([pos[:, :1] + float(offset), pos[:, 1:]], dim=1)

    def step(state: ShardedESState) -> ShardedESState:
        position, velocity, alive = state.position, state.velocity, \
            state.alive
        overflow = state.overflow

        # ---- deposit into the padded slab, fold the aprons --------------
        w = torch.where(alive, w0, 0.0).to(torch.float32)
        rho_pad = cic_deposit_packed(shift_x(position, APRON_W - ring.x_lo),
                                     w, pad_shape)
        with span("halo"):
            rho_local = halo.accumulate_apron(rho_pad, ring.group, APRON_W)

        # ---- distributed solve, gather, push ----------------------------
        e_pad = _solve_e_pad(config, ring, rho_local, HALO_W)
        e_at_p = cic_gather_packed(
            e_pad, shift_x(position, HALO_W - ring.x_lo), halo_shape)
        velocity = torch.where(alive[:, None], velocity + qm_dt * e_at_p,
                               0.0)
        x1 = position + dt * velocity / _dxv(config, position.device)
        max_disp = _max_disp(config, velocity, state.max_disp)

        # ---- wrap + migrate ---------------------------------------------
        gx = torch.remainder(x1[:, 0], float(nx))
        x1 = torch.cat([gx[:, None]] + [
            torch.remainder(x1[:, a:a + 1], float(rest[a - 1]))
            for a in range(1, ndim)], dim=1)
        if config.n_shards > 1:
            go_left, go_right = _migrate_masks(config, ring, gx, alive)
            res = migration.migrate_ring((x1, velocity), alive, go_left,
                                         go_right, ring.group,
                                         config.migration_buffer)
            (x1, velocity), alive = res.arrays, res.alive
            overflow = overflow + res.overflow
        # one shard: the slab is the periodic domain (the ring-distance
        # masks would flag every upper-half particle as a crosser)
        x1 = torch.where(alive[:, None], x1, 0.0)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              overflow=overflow, max_disp=max_disp)

    return step


def _wrap_and_migrate(config, ring, state, lp1, velocity, alive, overflow,
                      idx, ok, d_mask, n_tiles_ps):
    """The common tail of the sorted steps, in the ``migrate`` span: back
    to global units, then repair + stacked migration, or plain migration.
    While a profiler records, ``rows_migrated`` counts the alive rows that
    left the slab over either x face."""
    with span("migrate"):
        base = config.base
        H, tiling = config.halo_w, config.tiling
        gx = lp1[:, 0] - H
        count("rows_migrated",
              lambda: (alive & ((gx < 0) | (gx >= config.slab))).sum())
        if ring.x_lo:
            gx = gx + float(ring.x_lo)
        gx = torch.remainder(gx, float(base.grid_shape[0]))
        # the other axes wrap on their own periods, in one pass over the rows
        # (its x column is then replaced)
        x1 = torch.remainder(lp1, device_const(base.grid_shape, lp1.device))
        x1[:, 0] = gx
        ly1_w = x1[:, 1:]
        # one shard has no crossers; eager repair reads the masks even there
        go_left = go_right = None
        if config.n_shards > 1 or config.repair_eager:
            go_left, go_right = _migrate_masks(config, ring, gx, alive)
        extra = {}
        if config.repair:
            tid_fn = tile_ids if base.n_dim == 2 else tile_ids_3d

            def arrival_tiles(arrs):
                return tid_fn(_to_local(config, arrs[0], ring.x_lo),
                              config.pseudo_shape, tiling)

            (x1, velocity, alive, fidx, fcnt, sidx, scnt, unpl,
             overflow) = sharded_repair_migrate(
                x1, velocity, alive, state.tile_id, idx, ok, lp1[:, 0], ly1_w,
                go_left, go_right, state.free_idx, state.free_cnt,
                state.spare_idx, state.spare_cnt, state.unplaced, overflow,
                arrival_tiles, group=ring.group, n_shards=config.n_shards,
                migration_buffer=config.migration_buffer,
                pseudo_shape=config.pseudo_shape, tiling=tiling,
                n_tiles=n_tiles_ps, slab=config.slab, halo_w=H,
                in_win=~d_mask, eager_keep=config.repair_eager,
                eager_cap=config.eager_capacity or config.spill_capacity)
            extra = dict(free_idx=fidx, free_cnt=fcnt, spare_idx=sidx,
                         spare_cnt=scnt, unplaced=unpl)
        elif config.n_shards > 1:
            res = migration.migrate_ring((x1, velocity), alive, go_left,
                                         go_right, ring.group,
                                         config.migration_buffer)
            (x1, velocity), alive = res.arrays, res.alive
            overflow = overflow + res.overflow
        x1 = torch.where(alive[:, None], x1, 0.0)
        if config.repair or config.n_shards > 1:
            # rows moved: the steps zeroed the dead rows' velocities before
            velocity = torch.where(alive[:, None], velocity, 0.0)
        return x1, velocity, alive, overflow, extra


def make_sharded_sorted_es_step_fn(config: ShardedESConfig, mesh,
                                   axis: str = "space", on_spill=None):
    """The sorted composition in plain PyTorch (backend 'xla'), 2D or 3D:
    per-shard windowed deposit and gather on the halo-padded pseudo-grid,
    the exact patch of out-of-window rows, the distributed solve;
    ``on_spill`` as the fused composition's."""
    ring = _Ring(config, mesh, axis)
    base = config.base
    tiling, ndim = config.tiling, base.n_dim
    H, pseudo_shape = config.halo_w, config.pseudo_shape
    capacity = config.spill_capacity
    dt = base.dt
    qm_dt = base.charge / base.mass * dt
    w0 = base.charge / base.cell_volume
    n_tiles_ps = math.prod(tiling.n_tiles(pseudo_shape))
    deposit_fn = deposit_sorted_2d if ndim == 2 else deposit_sorted_3d
    gather_fn = gather_sorted_2d if ndim == 2 else gather_sorted_3d

    def step(state: ShardedESState) -> ShardedESState:
        position, alive = state.position, state.alive
        dev = position.device
        pseudo_f = device_const(pseudo_shape, dev)
        lp0 = _to_local(config, position, ring.x_lo)
        bad_block = state.tile_id >= n_tiles_ps

        # ---- sorted deposit + exact patch + apron fold ------------------
        w = torch.where(alive, w0, 0.0).to(torch.float32)
        rho_pad, _, d_mask = deposit_fn(lp0, torch.where(bad_block, 0.0, w),
                                        state.tile_id, pseudo_shape, tiling)
        d_mask = (d_mask | bad_block) & alive
        n_spill, idx = patch_rows(d_mask, (capacity,))
        if n_spill:
            rho_pad = rho_pad + cic_deposit_packed(
                torch.remainder(lp0[idx], pseudo_f), w[idx], pseudo_shape)
        with span("halo"):
            rho_local = halo.accumulate_apron(rho_pad, ring.group, H)

        # ---- distributed solve, sorted gather (patched) -----------------
        e_pad = _solve_e_pad(config, ring, rho_local, H)
        eb, g_inw = gather_fn(e_pad, lp0, state.tile_id, pseudo_shape,
                              tiling)
        g_mask = (~g_inw | bad_block) & alive
        n_g, g_idx = patch_rows(g_mask, (capacity,))
        if n_g:
            eb[g_idx] = cic_gather_packed(
                e_pad, torch.remainder(lp0[g_idx], pseudo_f), pseudo_shape)

        # ---- push + wrap + migrate --------------------------------------
        velocity = torch.where(alive[:, None],
                               state.velocity + qm_dt * eb, 0.0)
        lp1 = lp0 + dt * velocity / _dxv(config, dev)
        max_disp = _max_disp(config, velocity, state.max_disp)
        ok = torch.ones(idx.shape, dtype=torch.bool, device=dev)
        x1, velocity, alive, overflow, extra = _wrap_and_migrate(
            config, ring, state, lp1, velocity, alive, state.overflow, idx,
            ok, d_mask, n_tiles_ps)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              overflow=overflow, max_disp=max_disp,
                              **_spill_counts(config, state, n_spill,
                                              on_spill),
                              **extra)

    return step


def _n_tiles(config: ShardedESConfig) -> int:
    return math.prod(config.tiling.n_tiles(config.pseudo_shape))


def _precision(config: ShardedESConfig) -> str:
    return config.pallas_precision or (
        "default" if getattr(config.tiling, "dtype", "float32") == "bfloat16"
        else "highest")


def _fused_inputs(config: ShardedESConfig, ring: _Ring, state):
    """The fused kernel's arguments at ``state`` (E solved from the carried
    rho on the halo-padded window, the rows in the pseudo-grid frame,
    weights 0 on dead rows and trailing blocks), and the trailing-block
    mask."""
    return _kernel_args(config, ring, state, _solve_e_pad(
        config, ring, state.rho, config.halo_w))


def _kernel_args(config: ShardedESConfig, ring: _Ring, state, e_pad):
    """``_fused_inputs`` from E on the halo-padded window."""
    base = config.base
    bad_block = state.tile_id >= _n_tiles(config)
    w0 = base.charge / base.cell_volume
    w = torch.where(state.alive & ~bad_block, w0, 0.0).to(torch.float32)
    args = (e_pad, _to_local(config, state.position, ring.x_lo),
            state.velocity, w, state.tile_id, config.pseudo_shape,
            config.tiling, float(base.charge / base.mass * base.dt),
            *(float(base.dt / d) for d in base.cell_size))
    return args, bad_block


def _spill_counts(config: ShardedESConfig, state, n_spill: int,
                  on_spill=None) -> dict:
    """The step's spill added to the cumulative counts: every patched row,
    and the rows past ``spill_capacity`` (not patched: their deposits are
    lost); counts ``rows_patched``, and hands the step's rows dropped to
    ``on_spill`` on the host, where given."""
    dropped = max(n_spill - config.spill_capacity, 0)
    count("rows_patched", n_spill - dropped)
    if on_spill is not None:
        on_spill(dropped)
    return dict(spill=state.spill + n_spill,
                spill_dropped=state.spill_dropped + dropped)


def make_sharded_sorted_es_pallas_step_fn(config: ShardedESConfig, mesh,
                                          axis: str = "space",
                                          on_spill=None):
    """The fused composition (backend 'pallas'): solve E from the CARRIED
    per-shard rho (distributed), then one kernel a shard does gather +
    kick + drift + deposit on the pseudo-grid (B1 in 2D, B5 in 3D), the
    out-of-window rows are re-pushed exactly, the apron fold returns
    boundary deposits to their owners, and migration hands crossers
    over.  ``on_spill(dropped)`` hears each step's rows past
    ``spill_capacity`` on the host."""
    ring = _Ring(config, mesh, axis)
    dt = config.base.dt
    qm_dt = float(config.base.charge / config.base.mass * dt)
    w0 = config.base.charge / config.base.cell_volume
    pseudo_shape = config.pseudo_shape
    substep = (fused_es2d_substep if config.base.n_dim == 2
               else fused_es3d_substep)

    def step(state: ShardedESState) -> ShardedESState:
        alive = state.alive
        dev = alive.device
        pseudo_f = device_const(pseudo_shape, dev)
        # E from the carried rho, and the kernel's inputs on the
        # pseudo-grid; one fused kernel on them
        e_pad = _solve_e_pad(config, ring, state.rho, config.halo_w)
        with span("kernel"):
            args, bad_block = _kernel_args(config, ring, state, e_pad)
            lp0, vel0 = args[1:3]
            lp1, velocity, rho_pad, in_win = substep(
                *args, precision=_precision(config))

        # ---- exact patch of out-of-window and trailing-block rows -------
        with span("patch"):
            d_mask = (~in_win | bad_block) & alive
            n_spill, idx = patch_rows(d_mask, (config.spill_capacity,))
            if n_spill:        # (no row spilled: nothing to re-push)
                lp0_k = torch.remainder(lp0[idx], pseudo_f)
                vel_k = vel0[idx] + qm_dt * cic_gather_packed(
                    e_pad, lp0_k, pseudo_shape)
                lp1_k = lp0_k + dt * vel_k / _dxv(config, dev)
                rho_pad = rho_pad + cic_deposit_packed(
                    torch.remainder(lp1_k, pseudo_f),
                    torch.full(idx.shape, w0, dtype=torch.float32,
                               device=dev),
                    pseudo_shape)
                lp1[idx] = lp1_k
                velocity[idx] = vel_k
            velocity = torch.where(alive[:, None], velocity, 0.0)
            max_disp = _max_disp(config, velocity, state.max_disp)
            ok = torch.ones(idx.shape, dtype=torch.bool, device=dev)
            spilled = _spill_counts(config, state, n_spill, on_spill)
        with span("halo"):
            rho_new = halo.accumulate_apron(rho_pad, ring.group,
                                            config.halo_w)

        # ---- wrap + migrate ---------------------------------------------
        x1, velocity, alive, overflow, extra = _wrap_and_migrate(
            config, ring, state, lp1, velocity, alive, state.overflow, idx,
            ok, d_mask, _n_tiles(config))
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              overflow=overflow, max_disp=max_disp, rho=rho_new,
                              **spilled, **extra)

    return step


def make_sharded_es_seed_rho_fn(config: ShardedESConfig, mesh,
                                axis: str = "space"):
    """``seed(state) -> rho``: the deposit at the CURRENT positions (the
    packed scatter for the whole local population, folded) — seeds the
    pallas backend's carried rho."""
    ring = _Ring(config, mesh, axis)
    pseudo_shape = config.pseudo_shape
    w0 = config.base.charge / config.base.cell_volume

    def seed(state: ShardedESState) -> torch.Tensor:
        pseudo_f = device_const(pseudo_shape, state.position.device)
        lp = _to_local(config, state.position, ring.x_lo)
        w = torch.where(state.alive, w0, 0.0).to(torch.float32)
        rho_pad = cic_deposit_packed(torch.remainder(lp, pseudo_f), w,
                                     pseudo_shape)
        return halo.accumulate_apron(rho_pad, ring.group, config.halo_w)

    return seed


def make_sharded_es_free_init_fn(config: ShardedESConfig, mesh,
                                 axis: str = "space"):
    """``init(state) -> state`` (re)building this shard's free stacks for
    the repair composition (ops/repair.make_sharded_free_init)."""
    del mesh, axis  # the stacks are shard-local
    spare = config.spare_slots or max(config.repair_free_slots,
                                      2 * config.migration_buffer)
    local_init = make_sharded_free_init(
        config.tiling, config.pseudo_shape, config.tiling.block,
        config.repair_free_slots, spare)

    def init(state: ShardedESState) -> ShardedESState:
        fidx, fcnt, sidx, scnt = local_init(state.tile_id, state.alive)
        unplaced = state.unplaced if state.unplaced is not None else \
            torch.zeros((1,), dtype=torch.int64, device=state.alive.device)
        return state._replace(free_idx=fidx, free_cnt=fcnt, spare_idx=sidx,
                              spare_cnt=scnt, unplaced=unplaced)

    return init


def _relayout(config, state, lp, cell_order: bool):
    """``state`` with this shard's layout rebuilt from its rows' pseudo-grid
    coordinates ``lp`` (the global rows ride the sort as (N, d) payloads;
    with ``cell_order``, rows by cell inside each tile); rows that fall
    past the state's length count as overflow."""
    cap_state = config.cap_padded
    tid, _, pos, vel, alive_s, _ = build_padded_layout(
        lp, config.pseudo_shape, config.tiling, state.position,
        state.velocity, valid=state.alive,
        reserve=getattr(config, "repair", False), derive_valid=True,
        cell_order=cell_order)
    alive = alive_s[:cap_state]
    return state._replace(
        position=torch.where(alive[:, None], pos[:cap_state], 0.0),
        velocity=torch.where(alive[:, None], vel[:cap_state], 0.0),
        alive=alive, tile_id=tid[:cap_state],
        overflow=state.overflow + alive_s[cap_state:].sum())


def make_sharded_sorted_es_resort_fn(config: ShardedESConfig, mesh,
                                     axis: str = "space"):
    """``resort(state) -> state``: this shard's layout rebuilt on its
    pseudo-grid (rows by cell inside each tile in 3D, for B5); rows that
    fall past the state's length count as overflow."""
    ring = _Ring(config, mesh, axis)

    def resort(state: ShardedESState) -> ShardedESState:
        return _relayout(config, state,
                         _to_local(config, state.position, ring.x_lo),
                         config.base.n_dim == 3)

    return resort


class _ShardedShell:
    """What the sharded shells share: the reference's step cadence, the
    reads over the mesh (``gather_particles``, ``check_invariants``), and
    a state from the reference's global one (``_blob_state``).

    A subclass sets ``config``, ``sorted``, ``device``, ``state``,
    ``_step`` (and ``_resort``, sorted), ``_groups`` (the process groups
    of its mesh axes, innermost first: gathering over them in turn stacks
    the shards in the reference's order), ``_shard`` (this rank's index
    in that order) and ``_debug_note`` (the extent the displacement bound
    comes from, for ``debug_checks``' message)."""

    def _attach_ring(self, config, mesh, axis, device, apron: int):
        """The device, and the ring of a slab model (``mesh`` as
        ``_Ring`` takes it)."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self._ring = _Ring(config, mesh, axis)
        self._groups = (self._ring.group,)
        self._shard = self._ring.shard
        self._debug_note = f"slab={config.slab}, apron={apron}"
        self._multi_cache: dict = {}

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        for g in self._groups:
            dist.all_reduce(t, op=op, group=g)
        return t

    def _blob_state(self, state_cls, blob: dict, fields=(),
                    field_blocks=None, **dtypes):
        """``state_cls`` holding this rank's part of the reference's
        global state ``blob`` (numpy arrays): its shard's rows of every
        per-row and per-shard array, and its block (``field_blocks``,
        slices of the global grid) of the grid arrays named in
        ``fields``.  ``dtypes`` maps each key to its numpy dtype."""
        n = self.config.n_shards

        def part(key, dtype):
            if blob.get(key) is None:
                return None
            a = np.asarray(blob[key])
            if key in fields:
                a = a[field_blocks]
            else:
                rows = a.shape[0] // n
                a = a[self._shard * rows:(self._shard + 1) * rows]
            return torch.as_tensor(np.array(a, dtype), device=self.device)

        return state_cls(**{k: part(k, dt) for k, dt in dtypes.items()})

    def local_state(self) -> dict[str, np.ndarray]:
        """This rank's state as numpy arrays (its rows of the reference's
        global arrays)."""
        return {k: v.cpu().numpy() for k, v in self.state._asdict().items()
                if v is not None}

    def _resort_spanned(self, state):
        """``_resort`` (with repair, and the free stacks rebuilt) in the
        ``resort`` span."""
        with span("resort"):
            state = self._resort(state)
            if getattr(self.config, "repair", False):
                state = self._free_init(state)
            return state

    def step(self, n: int = 1) -> None:
        """Advance ``n`` steps with the reference's cadence: whole resort
        windows (steps, then the resort) where they fit, power-of-two
        chunks otherwise; with repair, one step at a time and the
        drain check at the end (one all_reduce).  The call is the
        ``step`` span."""
        with span("step"):
            cadence = self.config.resort_every if self.sorted else 10 ** 9
            repair = getattr(self.config, "repair", False)
            done = 0
            while done < n:
                if self.sorted and (self._since_sort >= cadence
                                    or getattr(self, "_need_resort", False)):
                    self.state = self._resort_spanned(self.state)
                    if repair:
                        self._need_resort = False
                    self._since_sort = 0
                since = self._since_sort if self.sorted else 0
                if (self.sorted and not repair and since == 0
                        and n - done >= cadence and cadence <= 128):
                    key = ("w", cadence)
                    if key not in self._multi_cache:
                        self._multi_cache[key] = make_window_step(
                            self._step, self._resort_spanned, cadence)
                    self.state = self._multi_cache[key](self.state)
                    done += cadence
                    continue
                k = pow2_chunk(min(n - done, min(cadence - since, 32)))
                if k <= 1 or repair:
                    self.state = self._step(self.state)
                    k = 1
                else:
                    if k not in self._multi_cache:
                        self._multi_cache[k] = make_multi_step(self._step, k)
                    self.state = self._multi_cache[k](self.state)
                if self.sorted:
                    self._since_sort += k
                done += k
            if repair:
                with span("drain_check"):
                    st = self.state
                    totals = self._all_reduce(torch.stack(
                        [st.unplaced.sum(), st.overflow.sum()]))
                    summed = types.SimpleNamespace(unplaced=totals[0],
                                                   overflow=totals[1])
                    self._need_resort, self._unplaced_seen, \
                        self._overflow_seen = drain_check(
                            summed, self._unplaced_seen, self._overflow_seen,
                            self.config.spill_capacity, self.config.capacity,
                            n)
            if self.config.debug_checks:
                inv = self.check_invariants()
                if not inv["disp_bound_ok"]:
                    raise RuntimeError(
                        f"migration invariant violated: max per-step "
                        f"displacement {inv['max_disp_cells']:.3f} cells >= "
                        f"bound {self.config.disp_bound:.3f} "
                        f"({self._debug_note}) — particle "
                        f"ownership/apron folding is no longer guaranteed; "
                        f"reduce dt or use wider slabs")

    def gather_particles(self) -> tuple[np.ndarray, np.ndarray]:
        """Every live particle of the mesh, on every rank, in shard
        order."""
        alive, pos, vel = (self.state.alive, self.state.position,
                           self.state.velocity)
        for g in self._groups:
            alive, pos, vel = (all_gather_rows(t, g) for t in (alive, pos,
                                                               vel))
        alive = alive.cpu().numpy()
        return pos.cpu().numpy()[alive], vel.cpu().numpy()[alive]

    def check_invariants(self) -> dict[str, float]:
        """The migration and apron preconditions as observed over the
        mesh: the largest move a step, the summed overflow."""
        md = self._all_reduce(self.state.max_disp.clone(),
                              dist.ReduceOp.MAX)
        ov = self._all_reduce(self.state.overflow.clone())
        md = float(md[0])
        return {"max_disp_cells": md, "overflow": int(ov[0]),
                "disp_bound_ok": md < self.config.disp_bound}


_ES_DTYPES = dict(
    position=np.float32, velocity=np.float32, alive=np.bool_,
    overflow=np.int64, max_disp=np.float32, tile_id=np.int32,
    spill=np.int64, rho=np.float32, free_idx=np.int64, free_cnt=np.int64,
    spare_idx=np.int64, spare_cnt=np.int64, unplaced=np.int64)


class ShardedElectrostaticPIC(_ShardedShell):
    """Stateful shell of one rank (mirrors ``ElectrostaticPIC``).

    ``mesh`` is a 1D ``DeviceMesh`` (or one with an ``axis`` dimension),
    or the ring's process group; its size must be ``config.n_shards``.
    Every rank passes the same global ``position``/``velocity`` and keeps
    the particles of its own slab.  Runs on the CUDA card unless given
    ``device="cpu"`` (NCCL on the card, gloo on the CPU).

    ``rows_dropped`` is the rank's ``spill_dropped`` kept on the host (the
    rows past ``spill_capacity`` since the build), readable without a
    device read."""

    rows_dropped = 0

    def __init__(self, config: ShardedESConfig, mesh, position, velocity,
                 axis: str = "space", device=None):
        self.config = config
        if config.backend not in ("xla", "pallas"):
            raise ValueError(f"backend {config.backend!r} (xla|pallas)")
        self.sorted = config.tiling is not None
        if config.backend == "pallas" and not self.sorted:
            raise ValueError("backend='pallas' needs the sorted composition "
                             "(pass a tiling)")
        if config.repair and not self.sorted:
            raise ValueError("repair=True needs the sorted composition")
        if config.repair_eager:
            if not config.repair:
                raise ValueError("repair_eager requires repair=True")
            if not 0 < config.repair_eager <= config.tiling.margin:
                raise ValueError(
                    f"repair_eager={config.repair_eager} needs a tiling and "
                    f"must be in 1..margin")
        resolve_precision(config.pallas_precision,
                          getattr(config.tiling, "dtype", "float32"))
        self._attach_ring(config, mesh, axis, device, APRON_W)
        dist_cfg = (dataclasses.replace(config, capacity=config.cap_padded)
                    if self.sorted else config)
        pos, vel, alive = distribute(dist_cfg,
                                     np.asarray(position, np.float32),
                                     np.asarray(velocity, np.float32),
                                     shard=self._shard)

        def zeros(dtype):
            return torch.zeros((1,), dtype=dtype, device=self.device)

        self.state = ShardedESState(
            position=torch.as_tensor(pos, device=self.device),
            velocity=torch.as_tensor(vel, device=self.device),
            alive=torch.as_tensor(alive, device=self.device),
            overflow=zeros(torch.int64), max_disp=zeros(torch.float32),
            tile_id=(torch.zeros(pos.shape[0], dtype=torch.int32,
                                 device=self.device)
                     if self.sorted else None),
            spill=zeros(torch.int64) if self.sorted else None,
            spill_dropped=zeros(torch.int64) if self.sorted else None)
        self._make_steps(mesh, axis)
        if self.sorted:
            self.state = self._resort(self.state)
            if config.repair:
                self.state = self._free_init(self.state)
            if config.backend == "pallas":
                self.state = self.state._replace(
                    rho=self._seed_rho(self.state))

    def _note_dropped(self, dropped: int) -> None:
        self.rows_dropped += dropped

    def _make_steps(self, mesh, axis):
        config = self.config
        if not self.sorted:
            self._step = make_sharded_es_step_fn(config, mesh, axis)
            return
        self._resort = make_sharded_sorted_es_resort_fn(config, mesh, axis)
        if config.repair:
            self._free_init = make_sharded_es_free_init_fn(config, mesh, axis)
            self._unplaced_seen = self._overflow_seen = 0
            self._need_resort = False
        make = (make_sharded_sorted_es_pallas_step_fn
                if config.backend == "pallas"
                else make_sharded_sorted_es_step_fn)
        if config.backend == "pallas":
            self._seed_rho = make_sharded_es_seed_rho_fn(config, mesh, axis)
        self._step = make(config, mesh, axis, on_spill=self._note_dropped)
        self._since_sort = 0

    @classmethod
    def from_state(cls, config: ShardedESConfig, mesh, blob: dict,
                   axis: str = "space", device=None
                   ) -> "ShardedElectrostaticPIC":
        """A shell on a given sorted state, with no initial resort: ``blob``
        holds the reference's global state as numpy arrays (``{k:
        np.asarray(v) for k, v in sim.state._asdict().items() if v is not
        None}``), and this rank takes its shard's rows of each.  Both
        packages then step from one layout, row for row."""
        if config.tiling is None:
            raise ValueError("from_state needs a sorted composition")
        self = cls.__new__(cls)
        self.config = config
        self.sorted = True
        self._attach_ring(config, mesh, axis, device, APRON_W)
        self.state = self._blob_state(ShardedESState, blob, **_ES_DTYPES)
        self.state = self.state._replace(spill_dropped=torch.zeros(
            (1,), dtype=torch.int64, device=self.device))
        self._make_steps(mesh, axis)
        if config.repair:
            self._unplaced_seen = int(blob["unplaced"].sum())
            self._overflow_seen = int(blob["overflow"].sum())
        return self

    def fused_substep_args(self) -> tuple:
        """The arguments the fused backend hands its kernel (B1 / B5) at
        the current state: E on the shard's halo-padded pseudo-grid, the
        rows in its frame, their weights and tiles, the pseudo-grid's
        shape and the coefficients."""
        return _fused_inputs(self.config, self._ring, self.state)[0]
