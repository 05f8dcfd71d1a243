"""Electrostatic PIC on a two-axis spatial mesh (port of
``fusion_sim_tpu/models/electrostatic_sharded2d.py``).

The grid splits over both leading axes on a ``DeviceMesh`` of shape (Sx,
Sy) with dimensions ("sx", "sy"): each rank owns an (x, y) block and the
particles inside it, so a block's surface (the halo and migration
traffic) shrinks as 1/sqrt(ranks).  One step, on the rank's own block:

    deposit (CIC into the two-axis apron-padded block)
    -> accumulate_apron_2d   (corner deposits ride two hops, no diagonal
                              message; parallel/halo.py)
    -> charge neutralization (an all_reduce on each mesh axis)
    -> the solve: 2D grids up to GATHERED_DFT_MAX all_gather rho on both
       axes and run the dense-DFT solve replicated (the 1-axis model's
       rule); larger 2D and every 3D grid all_gather the "sy" axis only
       and run the pencil FFT (ops/solvers.poisson_fft_sharded) over "sx"
    -> E = -grad(phi) on the two-axis halo-padded window
    -> gather + kick + drift
    -> migrate_grid          (x phase, then y phase: diagonal crossers
                              route in two hops; parallel/migration.py)

Each mesh axis's process group comes from the ``DeviceMesh``
(``mesh.get_group(dim)``); every collective goes to its axis's group.
The sorted compositions (a ``tiling``) keep each rank's particles in the
padded tile-sorted layout of a pseudo-grid padded on both decomposed
axes; ``backend='pallas'`` runs one fused kernel a step on it, B1
(``ops/fused_pic.fused_es2d_substep``) in 2D and B5
(``ops/fused_pic3d.fused_es3d_substep``) in 3D, with the carried-rho
step of the 1-axis model.  The pseudo-grid is not periodic on x or y:
rows live in the block, whose windows reach into the halos.  In 3D the
resort orders each tile's rows by cell, as the single-device 3D shell
does, for B5.

A rank's state holds its own shard; the shards stack in mesh order (ix
* Sy + iy), the reference's order.  Every entry point runs on the CUDA
card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.distributed as dist

from .._device import device_const, resolve_device
from ..ops.fused_pic import fused_es2d_substep
from ..ops.fused_pic3d import fused_es3d_substep
from ..ops.interp import cic_deposit_packed, cic_gather_packed, patch_rows
from ..ops.precision import f32_matmul, resolve_precision
from ..ops.solvers import poisson_dft2d, poisson_fft_sharded
from ..ops.sorted_deposit import (deposit_sorted_2d, deposit_sorted_3d,
                                  gather_sorted_2d, gather_sorted_3d)
from ..parallel import halo, migration
from ..parallel.mesh import all_gather_rows
from .electrostatic import ESConfig
from .electrostatic_sharded import (_ES_DTYPES, APRON_W, HALO_W,
                                    ShardedESState, _ShardedShell, _dxv,
                                    _max_disp, _n_tiles, _precision,
                                    _relayout, _spill_counts,
                                    _use_gathered_dft)


@dataclasses.dataclass(frozen=True)
class ShardedESConfig2D:
    """The two-axis decomposition (mesh axes "sx" x "sy" over grid axes 0
    and 1)."""

    base: ESConfig
    mesh_shape: tuple[int, int]   # (Sx, Sy)
    capacity: int                 # particle slots per shard
    migration_buffer: int         # max migrants per direction per phase
    # sorted compositions (tiling != None): per-shard tile-sorted padded
    # particles on a pseudo-grid padded on both decomposed axes; migrants
    # (diagonal two-phase crossers too) land in dead slots and take the
    # exact patch until the next per-shard resort
    tiling: object | None = None
    resort_every: int = 6
    spill_capacity: int = 16384
    # sorted compositions only: 'pallas' runs each shard's gather + kick +
    # drift + deposit in one kernel (B1 in 2D, B5 in 3D) with the
    # carried-rho step
    backend: str = "xla"
    # the reference's matmul strategy name, validated only (the port
    # computes in f32: ops/precision.py)
    pallas_precision: str | None = None
    debug_checks: bool = False

    @property
    def n_shards(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]

    @property
    def tile_xy(self) -> tuple[int, int]:
        """The tile's extent on each decomposed grid axis."""
        t = self.tiling
        return ((t.tile_r, t.tile_z) if self.base.n_dim == 2
                else (t.tile[0], t.tile[1]))

    @property
    def halo_ws(self) -> tuple[int, int]:
        """The sorted compositions' halo and apron width on each
        decomposed axis: whole tiles covering the margin, the CIC node and
        APRON_W, and at least 2*margin + 1 cells (windows never wrap onto
        a neighbour's real data)."""
        out = []
        m = self.tiling.margin
        for t in self.tile_xy:
            need = max(m + 2, APRON_W)
            h = -(-need // t) * t
            if h < 2 * m + 1:
                h += t
            out.append(h)
        return tuple(out)

    @property
    def pseudo_shape(self) -> tuple[int, ...]:
        sx, sy = self.slabs
        tx, ty = self.tile_xy
        if sx % tx or sy % ty:
            raise ValueError(f"block {self.slabs} not divisible by tiles "
                             f"({tx}, {ty})")
        hx, hy = self.halo_ws
        return (sx + 2 * hx, sy + 2 * hy, *self.base.grid_shape[2:])

    @property
    def cap_padded(self) -> int:
        if self.capacity % self.tiling.block:
            raise ValueError(f"capacity {self.capacity} not a multiple of "
                             f"block {self.tiling.block}")
        n_tiles = math.prod(self.tiling.n_tiles(self.pseudo_shape))
        return self.capacity + n_tiles * self.tiling.block

    @property
    def slabs(self) -> tuple[int, int]:
        out = []
        for a in range(2):
            n_a = self.base.grid_shape[a]
            s_a = self.mesh_shape[a]
            if n_a % s_a:
                raise ValueError(f"grid axis {a} ({n_a}) not divisible by "
                                 f"mesh axis {s_a}")
            slab = n_a // s_a
            if s_a > 1 and slab < 2 * APRON_W:
                raise ValueError(f"block width {slab} on axis {a} < "
                                 f"2*apron {2 * APRON_W}")
            out.append(slab)
        return tuple(out)

    @property
    def disp_bound(self) -> float:
        """Cells a step the decomposition tolerates (see
        ``ShardedESConfig.disp_bound``)."""
        bound = float(APRON_W - 1)
        for a in range(2):
            if self.mesh_shape[a] > 1:
                bound = min(bound, self.slabs[a] / 2.0)
        return bound


def distribute_2d(config, position: np.ndarray, velocity: np.ndarray,
                  shard: int | None = None):
    """Bucket global particles into per-shard fixed-capacity slots, the
    shard blocks in mesh order (ix * Sy + iy): ``(pos, vel, alive)`` for
    all shards stacked (the reference's arrays), or only shard
    ``shard``'s block.  Velocities keep their columns."""
    sx, sy = config.mesh_shape
    cap = config.capacity
    slab_x, slab_y = config.slabs
    d = config.base.n_dim
    shards = range(sx * sy) if shard is None else (shard,)
    pos = np.zeros((len(shards) * cap, d), np.float32)
    vel = np.zeros((len(shards) * cap, velocity.shape[1]), np.float32)
    alive = np.zeros((len(shards) * cap,), bool)
    ox = np.minimum((position[:, 0] // slab_x).astype(int), sx - 1)
    oy = np.minimum((position[:, 1] // slab_y).astype(int), sy - 1)
    owner = ox * sy + oy
    for k, s in enumerate(shards):
        mine = np.where(owner == s)[0]
        if len(mine) > cap:
            raise ValueError(f"shard {s}: {len(mine)} particles > "
                             f"capacity {cap}")
        pos[k * cap: k * cap + len(mine)] = position[mine]
        vel[k * cap: k * cap + len(mine)] = velocity[mine]
        alive[k * cap: k * cap + len(mine)] = True
    return pos, vel, alive


class _Mesh2D:
    """The step functions' view of the two-axis mesh: each axis's process
    group (from the ``DeviceMesh``), this rank's coordinates, block origin
    and shard index in mesh order."""

    def __init__(self, config, mesh, axes: tuple[str, str]):
        shape = tuple(mesh.shape)
        if shape != tuple(config.mesh_shape):
            raise ValueError(f"mesh shape {shape} != config mesh_shape "
                             f"{tuple(config.mesh_shape)}")
        self.groups = tuple(mesh.get_group(a) for a in axes)
        self.coords = tuple(mesh.get_coordinate())
        self.lows = tuple(c * s for c, s in zip(self.coords, config.slabs))
        self.shard = self.coords[0] * config.mesh_shape[1] + self.coords[1]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.reshape(1).clone()
        for g in self.groups:
            dist.all_reduce(out, group=g)
        return out[0]


def _all_gather_axis(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The ranks' blocks of ``group`` joined along ``axis`` in rank order
    (the reference's ``all_gather(..., axis, tiled=True)``)."""
    return all_gather_rows(t.movedim(axis, 0), group).movedim(0, axis)


def _phi_full_gathered_2d(rho_local: torch.Tensor, base: ESConfig,
                          groups) -> torch.Tensor:
    """The whole domain's phi on every rank: all_gather the blocks of rho
    along both mesh axes and run the dense-DFT solve replicated."""
    rho_rows = _all_gather_axis(rho_local, groups[0], 0)
    rho_full = _all_gather_axis(rho_rows, groups[1], 1)
    with f32_matmul():
        return poisson_dft2d(rho_full, base.cell_size, eps0=base.eps0)


@functools.lru_cache(maxsize=32)
def _axis_rows(n: int, lo: int, width: int, slab: int, device):
    """The global indices (periodic) of a block's window of ``width``
    cells a side on one axis, made once."""
    return torch.remainder(torch.arange(slab + 2 * width, device=device)
                           - width + lo, n)


def _e_pad_from_full_phi_2d(phi_full: torch.Tensor, lows, widths, slabs,
                            base: ESConfig) -> torch.Tensor:
    """E = -grad(phi) on the two-axis halo-padded window, from the
    replicated phi: a window one cell wider than the halo on each
    decomposed axis, central differences inside it (rolls), the outer
    ring trimmed (the rolls wrap only there)."""
    win = phi_full
    for a in range(2):
        win = win.index_select(a, _axis_rows(
            base.grid_shape[a], lows[a], widths[a] + 1, slabs[a],
            phi_full.device))
    grads = []
    for a in range(base.n_dim):
        up = torch.roll(win, -1, dims=a)
        dn = torch.roll(win, 1, dims=a)
        grads.append((up - dn) / (2.0 * base.cell_size[a]))
    # contiguous: the fused kernels read E as a dense grid
    return torch.stack([-g for g in grads], dim=-1)[1:-1, 1:-1].contiguous()


def _e_pad_pencil_2d(rho_local: torch.Tensor, base: ESConfig, groups,
                     lows, slabs, widths) -> torch.Tensor:
    """The 3D and large-2D solve: all_gather the "sy" axis into x-slabs of
    the whole y extent, the pencil FFT over "sx" (each sy row of the mesh
    runs its own copy), then E = -grad(phi) on the two-axis halo window:
    x by the halo'd central difference, the whole axes by rolls, the x
    halo exchanged and the y window taken from the whole extent."""
    rho_slab = _all_gather_axis(rho_local, groups[1], 1)
    phi_slab = poisson_fft_sharded(rho_slab, base.grid_shape,
                                   base.cell_size, groups[0],
                                   eps0=base.eps0)
    phi_pad = halo.with_halo(phi_slab, groups[0], 1)
    grads = [(phi_pad[2:] - phi_pad[:-2]) / (2.0 * base.cell_size[0])]
    for a in range(1, base.n_dim):
        up = torch.roll(phi_slab, -1, dims=a)
        dn = torch.roll(phi_slab, 1, dims=a)
        grads.append((up - dn) / (2.0 * base.cell_size[a]))
    e_pad = halo.with_halo(torch.stack([-g for g in grads], dim=-1),
                           groups[0], widths[0])
    return e_pad.index_select(1, _axis_rows(
        base.grid_shape[1], lows[1], widths[1], slabs[1], e_pad.device))


def _solve_e_pad_2d(config, m2: _Mesh2D, rho_local, widths):
    """E on the rank's window of ``widths`` halo cells a side, from its
    rho block: neutralized (an all_reduce on each axis), then the
    gathered dense-DFT route or the pencil route."""
    base = config.base
    if base.neutralizing_background:
        rho_local = rho_local - m2.psum(torch.sum(rho_local)) / float(
            math.prod(base.grid_shape))
    if _use_gathered_dft(base):
        return _e_pad_from_full_phi_2d(
            _phi_full_gathered_2d(rho_local, base, m2.groups), m2.lows,
            widths, config.slabs, base)
    return _e_pad_pencil_2d(rho_local, base, m2.groups, m2.lows,
                            config.slabs, widths)


def _shift_xy(position: torch.Tensor, off_x, off_y) -> torch.Tensor:
    out = position.clone()
    out[:, 0] += float(off_x)
    out[:, 1] += float(off_y)
    return out


def _make_to_local_2d(config):
    """``to_local(position, x_lo, y_lo)``: global grid units -> the
    two-axis pseudo-grid frame (the 1-axis model's block-centred wrap on
    each decomposed axis, plus the halo; the reference's f32 operations
    in its order, a shift by 0 left out, which changes no value)."""
    hws = config.halo_ws
    tail = [(n, (n - s) / 2, h) for n, s, h in zip(
        config.base.grid_shape[:2], config.slabs, hws)]

    def to_local(position, x_lo: int, y_lo: int):
        out = position.clone()
        for a, ((n, off, h), lo) in enumerate(zip(tail, (x_lo, y_lo))):
            c = position[:, a]
            if lo:
                c = c - float(lo)
            if off:
                c = c + off
            c = torch.remainder(c, float(n))
            if off:
                c = c - off
            out[:, a] = c + h
        return out

    return to_local


def _make_grid_mig(config, m2: _Mesh2D):
    """``migrate(arrays, alive, overflow)``: the dimension-ordered
    migration of the two-axis models (``migration.migrate_grid`` over the
    axes with more than one shard): phase k's masks read the CURRENT
    positions, so diagonal crossers route x then y."""
    nx, ny = config.base.grid_shape[:2]
    slabs = config.slabs
    mig = [a for a in range(2) if config.mesh_shape[a] > 1]
    span = {0: nx, 1: ny}

    def mask_fn(arrays, k):
        a = mig[k]
        slab, n_a = slabs[a], float(span[a])
        lo = float(m2.lows[a])
        g = arrays[0][:, a]
        d_lo = torch.remainder(lo - g, n_a)
        go_lo = (d_lo > 0) & (d_lo <= slab / 2)
        go_hi = torch.remainder(g - (lo + slab), n_a) < slab / 2
        return go_lo, go_hi

    def migrate(arrays, alive, overflow):
        if not mig:
            return arrays, alive, overflow
        res = migration.migrate_grid(arrays, alive, mask_fn,
                                     [m2.groups[a] for a in mig],
                                     config.migration_buffer)
        return res.arrays, res.alive, overflow + res.overflow

    return migrate


def _wrap_back_2d(config, m2: _Mesh2D, lp1: torch.Tensor) -> torch.Tensor:
    """Pseudo-grid rows back to global grid units, every axis wrapped."""
    x1 = lp1.clone()
    for a, (lo, h) in enumerate(zip(m2.lows, config.halo_ws)):
        x1[:, a] = lp1[:, a] - h
        if lo:
            x1[:, a] += float(lo)
    return torch.remainder(x1, device_const(config.base.grid_shape,
                                            lp1.device))


def make_sharded_es_step_fn_2d(config: ShardedESConfig2D, mesh,
                               axes: tuple[str, str] = ("sx", "sy")):
    """``step(state) -> state`` of the plain (unsorted) composition on the
    two-axis mesh, on this rank's block."""
    m2 = _Mesh2D(config, mesh, axes)
    base = config.base
    rest = base.grid_shape[2:]
    slab_x, slab_y = config.slabs
    dt = base.dt
    qm_dt = base.charge / base.mass * dt
    w0 = base.charge / base.cell_volume
    pad_shape = (slab_x + 2 * APRON_W, slab_y + 2 * APRON_W, *rest)
    halo_shape = (slab_x + 2 * HALO_W, slab_y + 2 * HALO_W, *rest)
    migrate = _make_grid_mig(config, m2)
    x_lo, y_lo = m2.lows

    def step(state: ShardedESState) -> ShardedESState:
        position, alive = state.position, state.alive
        # ---- deposit into the two-axis padded block, fold the aprons ---
        w = torch.where(alive, w0, 0.0).to(torch.float32)
        rho_pad = cic_deposit_packed(
            _shift_xy(position, APRON_W - x_lo, APRON_W - y_lo), w,
            pad_shape)
        rho_local = halo.accumulate_apron_2d(rho_pad, m2.groups,
                                             (APRON_W, APRON_W))
        # ---- solve, gather, push ----------------------------------------
        e_pad = _solve_e_pad_2d(config, m2, rho_local, (HALO_W, HALO_W))
        e_at_p = cic_gather_packed(
            e_pad, _shift_xy(position, HALO_W - x_lo, HALO_W - y_lo),
            halo_shape)
        velocity = torch.where(alive[:, None],
                               state.velocity + qm_dt * e_at_p, 0.0)
        x1 = position + dt * velocity / _dxv(config, position.device)
        max_disp = _max_disp(config, velocity, state.max_disp)
        # ---- wrap + dimension-ordered migration --------------------------
        x1 = torch.remainder(x1, device_const(base.grid_shape, x1.device))
        (x1, velocity), alive, overflow = migrate((x1, velocity), alive,
                                                  state.overflow)
        x1 = torch.where(alive[:, None], x1, 0.0)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              overflow=overflow, max_disp=max_disp)

    return step


def make_sharded_sorted_es_step_fn_2d(config: ShardedESConfig2D, mesh,
                                      axes: tuple[str, str] = ("sx", "sy")):
    """The sorted composition in plain PyTorch (backend 'xla'), 2D or 3D:
    per-shard windowed deposit and gather on the two-axis pseudo-grid, the
    exact patch of out-of-window rows, two-axis apron folds, the solve,
    dimension-ordered migration."""
    m2 = _Mesh2D(config, mesh, axes)
    base = config.base
    tiling, ndim = config.tiling, base.n_dim
    pseudo_shape, capacity = config.pseudo_shape, config.spill_capacity
    dt = base.dt
    qm_dt = base.charge / base.mass * dt
    w0 = base.charge / base.cell_volume
    n_tiles = _n_tiles(config)
    deposit_fn = deposit_sorted_2d if ndim == 2 else deposit_sorted_3d
    gather_fn = gather_sorted_2d if ndim == 2 else gather_sorted_3d
    to_local = _make_to_local_2d(config)
    migrate = _make_grid_mig(config, m2)

    def step(state: ShardedESState) -> ShardedESState:
        alive = state.alive
        dev = alive.device
        pseudo_f = device_const(pseudo_shape, dev)
        lp0 = to_local(state.position, *m2.lows)
        bad_block = state.tile_id >= n_tiles

        # ---- sorted deposit + exact patch + two-axis apron fold ----------
        w = torch.where(alive, w0, 0.0).to(torch.float32)
        rho_pad, _, d_mask = deposit_fn(lp0, torch.where(bad_block, 0.0, w),
                                        state.tile_id, pseudo_shape, tiling)
        d_mask = (d_mask | bad_block) & alive
        n_spill, idx = patch_rows(d_mask, (capacity,))
        if n_spill:
            rho_pad = rho_pad + cic_deposit_packed(
                torch.remainder(lp0[idx], pseudo_f), w[idx], pseudo_shape)
        rho_local = halo.accumulate_apron_2d(rho_pad, m2.groups,
                                             config.halo_ws)

        # ---- the solve on the two-axis window, sorted gather (patched) ---
        e_pad = _solve_e_pad_2d(config, m2, rho_local, config.halo_ws)
        eb, g_inw = gather_fn(e_pad, lp0, state.tile_id, pseudo_shape,
                              tiling)
        g_mask = (~g_inw | bad_block) & alive
        n_g, g_idx = patch_rows(g_mask, (capacity,))
        if n_g:
            eb[g_idx] = cic_gather_packed(
                e_pad, torch.remainder(lp0[g_idx], pseudo_f), pseudo_shape)

        # ---- push + wrap + migrate ----------------------------------------
        velocity = torch.where(alive[:, None],
                               state.velocity + qm_dt * eb, 0.0)
        lp1 = lp0 + dt * velocity / _dxv(config, dev)
        max_disp = _max_disp(config, velocity, state.max_disp)
        (x1, velocity), alive, overflow = migrate(
            (_wrap_back_2d(config, m2, lp1), velocity), alive,
            state.overflow)
        x1 = torch.where(alive[:, None], x1, 0.0)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              overflow=overflow, max_disp=max_disp,
                              **_spill_counts(config, state, n_spill))

    return step


def _fused_inputs_2d(config, m2: _Mesh2D, state):
    """The fused kernel's arguments at ``state`` (E solved from the carried
    rho on the two-axis halo window, the rows in the pseudo-grid frame,
    weights 0 on dead rows and trailing blocks), and the trailing-block
    mask."""
    base = config.base
    bad_block = state.tile_id >= _n_tiles(config)
    e_pad = _solve_e_pad_2d(config, m2, state.rho, config.halo_ws)
    w0 = base.charge / base.cell_volume
    w = torch.where(state.alive & ~bad_block, w0, 0.0).to(torch.float32)
    args = (e_pad, _make_to_local_2d(config)(state.position, *m2.lows),
            state.velocity, w, state.tile_id, config.pseudo_shape,
            config.tiling, float(base.charge / base.mass * base.dt),
            *(float(base.dt / d) for d in base.cell_size))
    return args, bad_block


def make_sharded_sorted_es_pallas_step_fn_2d(
        config: ShardedESConfig2D, mesh,
        axes: tuple[str, str] = ("sx", "sy")):
    """The fused composition (backend 'pallas') on the two-axis mesh:
    solve E from the CARRIED per-shard rho, one kernel a shard does gather
    + kick + drift + deposit on the pseudo-grid (B1 in 2D, B5 in 3D), the
    out-of-window and trailing-block rows are re-pushed exactly, the
    two-axis apron fold returns boundary deposits to their owners, and
    dimension-ordered migration hands crossers over."""
    m2 = _Mesh2D(config, mesh, axes)
    dt = config.base.dt
    qm_dt = float(config.base.charge / config.base.mass * dt)
    w0 = config.base.charge / config.base.cell_volume
    pseudo_shape = config.pseudo_shape
    substep = (fused_es2d_substep if config.base.n_dim == 2
               else fused_es3d_substep)
    migrate = _make_grid_mig(config, m2)

    def step(state: ShardedESState) -> ShardedESState:
        alive = state.alive
        dev = alive.device
        pseudo_f = device_const(pseudo_shape, dev)
        args, bad_block = _fused_inputs_2d(config, m2, state)
        e_pad, lp0, vel0 = args[:3]
        lp1, velocity, rho_pad, in_win = substep(
            *args, precision=_precision(config))

        # ---- exact patch of out-of-window and trailing-block rows -------
        d_mask = (~in_win | bad_block) & alive
        n_spill, idx = patch_rows(d_mask, (config.spill_capacity,))
        if n_spill:
            lp0_k = torch.remainder(lp0[idx], pseudo_f)
            vel_k = vel0[idx] + qm_dt * cic_gather_packed(e_pad, lp0_k,
                                                          pseudo_shape)
            lp1_k = lp0_k + dt * vel_k / _dxv(config, dev)
            rho_pad = rho_pad + cic_deposit_packed(
                torch.remainder(lp1_k, pseudo_f),
                torch.full(idx.shape, w0, dtype=torch.float32, device=dev),
                pseudo_shape)
            lp1[idx] = lp1_k
            velocity[idx] = vel_k
        velocity = torch.where(alive[:, None], velocity, 0.0)
        rho_new = halo.accumulate_apron_2d(rho_pad, m2.groups,
                                           config.halo_ws)

        # ---- wrap + migrate -----------------------------------------------
        max_disp = _max_disp(config, velocity, state.max_disp)
        (x1, velocity), alive, overflow = migrate(
            (_wrap_back_2d(config, m2, lp1), velocity), alive,
            state.overflow)
        x1 = torch.where(alive[:, None], x1, 0.0)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              overflow=overflow, max_disp=max_disp,
                              rho=rho_new,
                              **_spill_counts(config, state, n_spill))

    return step


def make_sharded_es_seed_rho_fn_2d(config: ShardedESConfig2D, mesh,
                                   axes: tuple[str, str] = ("sx", "sy")):
    """``seed(state) -> rho``: the deposit at the CURRENT positions (the
    packed scatter, folded on both axes) — seeds the pallas backend's
    carried rho."""
    m2 = _Mesh2D(config, mesh, axes)
    pseudo_shape = config.pseudo_shape
    w0 = config.base.charge / config.base.cell_volume
    to_local = _make_to_local_2d(config)

    def seed(state: ShardedESState) -> torch.Tensor:
        pseudo_f = device_const(pseudo_shape, state.position.device)
        lp = to_local(state.position, *m2.lows)
        w = torch.where(state.alive, w0, 0.0).to(torch.float32)
        rho_pad = cic_deposit_packed(torch.remainder(lp, pseudo_f), w,
                                     pseudo_shape)
        return halo.accumulate_apron_2d(rho_pad, m2.groups, config.halo_ws)

    return seed


def make_sharded_sorted_es_resort_fn_2d(
        config: ShardedESConfig2D, mesh,
        axes: tuple[str, str] = ("sx", "sy")):
    """``resort(state) -> state``: this shard's layout rebuilt in its
    two-axis pseudo-grid frame (no communication; rows by cell inside each
    tile in 3D, for B5)."""
    m2 = _Mesh2D(config, mesh, axes)
    to_local = _make_to_local_2d(config)

    def resort(state: ShardedESState) -> ShardedESState:
        return _relayout(config, state, to_local(state.position, *m2.lows),
                         config.base.n_dim == 3)

    return resort


class _Mesh2DShell(_ShardedShell):
    """The two-axis shells' attachment to their mesh, and their state
    from the reference's global one."""

    def _attach_mesh(self, config, mesh, axes, device, apron: int):
        self.device = resolve_device(device)
        self.mesh = mesh
        self._m2 = _Mesh2D(config, mesh, axes)
        # gathers run over "sy", then "sx": the shards stack as ix*Sy + iy
        self._groups = self._m2.groups[::-1]
        self._shard = self._m2.shard
        self._debug_note = f"blocks={config.slabs}, apron={apron}"
        self._multi_cache: dict = {}

    def _blocks(self):
        return tuple(slice(lo, lo + s)
                     for lo, s in zip(self._m2.lows, self.config.slabs))


class ShardedElectrostaticPIC2D(_Mesh2DShell):
    """Stateful shell of one rank on the two-axis mesh (mirrors
    ``ShardedElectrostaticPIC``).

    ``mesh`` is a ``DeviceMesh`` of shape ``config.mesh_shape`` with the
    dimensions ``axes``.  Every rank passes the same global
    ``position``/``velocity`` and keeps the particles of its own block.
    Runs on the CUDA card unless given ``device="cpu"``."""

    def __init__(self, config: ShardedESConfig2D, mesh, position, velocity,
                 axes: tuple[str, str] = ("sx", "sy"), device=None):
        self.config = config
        if config.base.n_dim < 2:
            raise ValueError("2-D decomposition needs an >= 2-D grid")
        self.sorted = config.tiling is not None
        if config.backend not in ("xla", "pallas"):
            raise ValueError(f"backend {config.backend!r} (xla|pallas)")
        if config.backend == "pallas" and not self.sorted:
            raise ValueError("backend='pallas' needs the sorted composition "
                             "(pass a tiling)")
        resolve_precision(config.pallas_precision,
                          getattr(config.tiling, "dtype", "float32"))
        self._attach_mesh(config, mesh, axes, device, APRON_W)
        dist_cfg = (dataclasses.replace(config, capacity=config.cap_padded)
                    if self.sorted else config)
        pos, vel, alive = distribute_2d(dist_cfg,
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
        self._make_steps(mesh, axes)
        if self.sorted:
            self.state = self._resort(self.state)
            if config.backend == "pallas":
                self.state = self.state._replace(
                    rho=self._seed_rho(self.state))

    def _make_steps(self, mesh, axes):
        config = self.config
        if not self.sorted:
            self._step = make_sharded_es_step_fn_2d(config, mesh, axes)
            return
        self._resort = make_sharded_sorted_es_resort_fn_2d(config, mesh,
                                                           axes)
        if config.backend == "pallas":
            self._seed_rho = make_sharded_es_seed_rho_fn_2d(config, mesh,
                                                            axes)
            self._step = make_sharded_sorted_es_pallas_step_fn_2d(
                config, mesh, axes)
        else:
            self._step = make_sharded_sorted_es_step_fn_2d(config, mesh,
                                                           axes)
        self._since_sort = 0

    @classmethod
    def from_state(cls, config: ShardedESConfig2D, mesh, blob: dict,
                   axes: tuple[str, str] = ("sx", "sy"), device=None
                   ) -> "ShardedElectrostaticPIC2D":
        """A shell on a given sorted state, with no initial resort: ``blob``
        holds the reference's global state as numpy arrays, and this rank
        takes its shard's rows of each (and its block of the carried
        rho)."""
        if config.tiling is None:
            raise ValueError("from_state needs a sorted composition")
        self = cls.__new__(cls)
        self.config = config
        self.sorted = True
        self._attach_mesh(config, mesh, axes, device, APRON_W)
        self.state = self._blob_state(ShardedESState, blob, fields=("rho",),
                                      field_blocks=self._blocks(),
                                      **_ES_DTYPES)
        self.state = self.state._replace(spill_dropped=torch.zeros(
            (1,), dtype=torch.int64, device=self.device))
        self._make_steps(mesh, axes)
        return self

    def fused_substep_args(self) -> tuple:
        """The arguments the fused backend hands its kernel (B1 / B5) at
        the current state: E on the shard's two-axis halo window, the
        rows in its frame, their weights and tiles, the pseudo-grid's
        shape and the coefficients."""
        return _fused_inputs_2d(self.config, self._m2, self.state)[0]
