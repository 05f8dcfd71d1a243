"""Spatially decomposed electromagnetic PIC (port of
``fusion_sim_tpu/models/electromagnetic_sharded.py``), 2D3V and 3D3V.

The grid splits into x-slabs, one a rank of a process group (the ring);
each rank owns its field slab and the particles inside it, in
fixed-capacity slots with dead-slot masking.  Communication is between
ring neighbours only:

* field halos (``parallel/halo.with_halo``) pad each slab for the
  particle gather and the Yee curls;
* the deposition apron folds current deposited past a slab's edges back
  onto the owning neighbour (``halo.accumulate_apron``);
* particles crossing a slab boundary migrate through fixed-capacity
  buffers with overflow accounting (``parallel/migration.migrate_ring``).

The reference runs one step inside ``shard_map``; the port runs one
process a rank with explicit collectives, as the sharded ES model does
(``models/electrostatic_sharded.py``, whose ring, frame shift, spill
compaction and wrap-and-migrate tail this module shares).

The sorted compositions (a ``tiling``) keep each rank's particles in the
padded tile-sorted layout of a halo-padded pseudo-grid (the slab plus
``halo_w`` cells a side).  With ``gather_backend='fused'`` one kernel a
step does each rank's gather + Boris + drift + Esirkepov on that
pseudo-grid: B4 (``ops/fused_em.fused_em2d_substep``) in 2D3V and B6
(``ops/fused_em3d.fused_em3d_substep``) in 3D3V, as in the single-device
model; out-of-window rows and rows of the trailing dead blocks are then
re-pushed exactly from their original rows.  In 2D the fused layout
orders each tile's rows by cell, as the single-device fused 2D shell
does.  ``repair=True`` relocates spilled rows into their new tile every
step and seats migration arrivals straight into their tile's segment
(``ops/repair.sharded_repair_migrate``).

Positions are global grid units; each rank's state holds its own shard
(the reference's global arrays are the ranks' states stacked).  Every
entry point runs on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import device_const
from ..ops import fdtd
from ..ops.esirkepov import esirkepov_deposit_2d, esirkepov_deposit_3d
from ..ops.fused_em import fused_em2d_substep
from ..ops.fused_em3d import fused_em3d_substep
from ..ops.interp import cic_gather_packed, patch_rows
from ..ops.precision import resolve_precision
from ..ops.sorted_deposit import (esirkepov_sorted_2d, esirkepov_sorted_3d,
                                  gather_sorted_2d, gather_sorted_3d)
from ..parallel import halo, migration
from .electromagnetic import EMConfig, _coord_velocity, _offsets, boris_kick
from .electrostatic_sharded import (_Ring, _ShardedShell, _dxv, _max_disp,
                                    _migrate_masks, _n_tiles, _relayout,
                                    _spill_counts, _to_local,
                                    _wrap_and_migrate, distribute,
                                    make_sharded_es_free_init_fn)

HALO_W = 2     # field halo for gathers + curls (CIC corners + stagger shift)
APRON_W = 4    # deposition apron (Esirkepov 3-node stencil + 1 cell motion)


class ShardedEMState(NamedTuple):
    """One rank's shard of the reference's state (its rows of the global
    arrays, its slab of the fields; the per-shard vectors have length
    1)."""

    position: torch.Tensor   # (cap, d) global grid units (dead: 0)
    velocity: torch.Tensor   # (cap, 3)
    alive: torch.Tensor      # (cap,) bool
    e: torch.Tensor          # (slab, *rest, 3)
    b: torch.Tensor          # (slab, *rest, 3)
    overflow: torch.Tensor   # (1,) cumulative migration overflow
    max_disp: torch.Tensor   # (1,) max per-step displacement seen (cells)
    # sorted compositions only:
    tile_id: torch.Tensor | None = None
    spill: torch.Tensor | None = None
    # repair=True only (see electrostatic_sharded.ShardedESState):
    free_idx: torch.Tensor | None = None
    free_cnt: torch.Tensor | None = None
    spare_idx: torch.Tensor | None = None
    spare_cnt: torch.Tensor | None = None
    unplaced: torch.Tensor | None = None
    # sorted compositions: cumulative rows past spill_capacity (their
    # deposits lost), which the reference does not count
    spill_dropped: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class ShardedEMConfig:
    base: EMConfig
    n_shards: int
    capacity: int          # particle slots per shard
    migration_buffer: int  # max migrants per direction per step
    # sorted compositions (tiling != None): per-shard tile-sorted padded
    # particles on a halo-padded pseudo-grid; migrants land in dead slots
    # and take the exact patch (up to spill_capacity rows a step) until the
    # next per-shard resort
    tiling: object | None = None
    resort_every: int = 6
    spill_capacity: int = 16384
    # sorted compositions only: 'fused' runs each shard's gather + Boris +
    # drift + Esirkepov in one kernel on the pseudo-grid (B4 in 2D3V, B6
    # in 3D3V)
    gather_backend: str = "xla"
    # the reference's matmul strategy name, validated only (the port
    # computes in f32: ops/precision.py)
    pallas_precision: str | None = None
    # sorted compositions only: incremental layout repair (ops/repair.py)
    repair: bool = False
    repair_free_slots: int = 256
    repair_eager: int = 0
    eager_capacity: int | None = None
    spare_slots: int | None = None
    # True: check the displacement bound after every step() (raises
    # RuntimeError; one gather over the ring a step() call)
    debug_checks: bool = False

    @property
    def disp_bound(self) -> float:
        """Cells a step of motion the decomposition tolerates: the
        migration masks need < slab/2, the deposition apron covers
        APRON_W - stencil-reach cells of motion."""
        return min(self.slab / 2.0, float(APRON_W - 2))

    @property
    def slab(self) -> int:
        nx = self.base.grid_shape[0]
        if nx % self.n_shards:
            raise ValueError(f"nx={nx} not divisible by {self.n_shards} "
                             f"shards")
        slab = nx // self.n_shards
        if slab < APRON_W:
            raise ValueError(
                f"slab width {slab} < deposition apron {APRON_W}; use fewer "
                "shards or a finer x-grid")
        return slab

    @property
    def tile_x(self) -> int:
        t = self.tiling
        return t.tile_r if self.base.n_dim == 2 else t.tile[0]

    @property
    def halo_w(self) -> int:
        """The sorted compositions' halo and apron width: whole x-tiles
        covering the gather window's reach (margin + CIC corner + field
        centering) and the Esirkepov apron, and at least 2*margin + 1
        cells (windows of halo tiles wrap the pseudo-grid's edge; rows
        never reach the wrapped cells)."""
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


def _padded(f: torch.Tensor, groups, widths) -> torch.Tensor:
    """``f`` with ``widths[a]`` halo cells a side on each decomposed axis
    ``a`` (one group an axis, from axis 0: ``halo.with_halo_2d``'s order,
    so corners ride two hops)."""
    for axis, (g, w) in enumerate(zip(groups, widths)):
        f = halo.with_halo(f, g, w, axis)
    return f


def _table(base: EMConfig, e, b, groups, widths) -> torch.Tensor:
    """The node-centered (·, 6) E|B table on the halo-padded window.  It
    is not periodic on the decomposed axes: the centering rolls wrap only
    the outermost halo cells, which in-block rows never read."""
    return fdtd.center_fields(_padded(e, groups, widths),
                              _padded(b, groups, widths), *_offsets(base))


def _yee_local(base: EMConfig, e, b, j, groups):
    """The Yee leapfrog on a rank's block (B half, E full, B half), each
    curl over a one-cell halo on the decomposed axes (the reference's
    operation order)."""
    trim, ones = (slice(1, -1),) * len(groups), (1,) * len(groups)

    def curl_e_local(f):
        return fdtd.curl_e(_padded(f, groups, ones), base.cell_size)[trim]

    def curl_b_local(f):
        return fdtd.curl_b(_padded(f, groups, ones), base.cell_size)[trim]

    dt = base.dt
    b_half = b - (0.5 * dt) * curl_e_local(e)
    e_new = e + dt * ((base.c ** 2) * curl_b_local(b_half) - j / base.eps0)
    b_new = b_half - (0.5 * dt) * curl_e_local(e_new)
    return e_new, b_new


def _esirkepov(base: EMConfig, x0, x1, coord_v, charge, shape):
    """The exact Esirkepov deposit of ``x0 -> x1`` (unwrapped) on a grid of
    ``shape``; ``coord_v`` gives the 2D3V z-current."""
    if base.n_dim == 2:
        return esirkepov_deposit_2d(x0, x1, coord_v[:, 2], charge, base.dt,
                                    shape, base.cell_size)
    return esirkepov_deposit_3d(x0, x1, charge, base.dt, shape,
                                base.cell_size)


def _qm_half_dt(base: EMConfig) -> float:
    return base.charge / base.mass * base.dt * 0.5


def make_sharded_step_fn(config: ShardedEMConfig, mesh, axis: str = "space"):
    """``step(state) -> state`` of the plain (unsorted) composition, on
    this rank's shard."""
    ring = _Ring(config, mesh, axis)
    base = config.base
    ndim, rest = base.n_dim, base.grid_shape[1:]
    nx, slab, dt = base.grid_shape[0], config.slab, base.dt
    pad_shape = (slab + 2 * APRON_W, *rest)
    halo_shape = (slab + 2 * HALO_W, *rest)
    groups = (ring.group,)

    def shift_x(pos, offset):
        return torch.cat([pos[:, :1] + float(offset), pos[:, 1:]], dim=1)

    def step(state: ShardedEMState) -> ShardedEMState:
        position, alive, overflow = state.position, state.alive, \
            state.overflow

        # ---- field halos, gather, push -----------------------------------
        table = _table(base, state.e, state.b, groups, (HALO_W,))
        eb = cic_gather_packed(table, shift_x(position, HALO_W - ring.x_lo),
                               halo_shape)
        velocity = boris_kick(state.velocity, eb[:, :3], eb[:, 3:],
                              _qm_half_dt(base), base.relativistic, base.c)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        # unwrapped until after deposition: Esirkepov reads the actual
        # x0 -> x1 motion
        x1 = position + dt * velocity[:, :ndim] / _dxv(config,
                                                       position.device)
        max_disp = _max_disp(config, velocity[:, :ndim], state.max_disp)

        # ---- deposit into the padded slab, fold the aprons, Yee ----------
        charge = torch.where(alive, base.charge, 0.0).to(torch.float32)
        j_pad = _esirkepov(base, shift_x(position, APRON_W - ring.x_lo),
                           shift_x(x1, APRON_W - ring.x_lo), velocity,
                           charge, pad_shape)
        j_local = halo.accumulate_apron(j_pad, ring.group, APRON_W)
        e_new, b_new = _yee_local(base, state.e, state.b, j_local, groups)

        # ---- wrap + migrate ---------------------------------------------
        x1 = torch.remainder(x1, device_const(base.grid_shape, x1.device))
        if config.n_shards > 1:
            go_left, go_right = _migrate_masks(config, ring, x1[:, 0], alive)
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
                              e=e_new, b=b_new, overflow=overflow,
                              max_disp=max_disp)

    return step


def _check_backend(config) -> None:
    if config.gather_backend not in ("xla", "fused"):
        raise ValueError(f"gather_backend {config.gather_backend!r} "
                         "(xla|fused)")


def _fused_args(config, table, lp0, state, bad_block) -> tuple:
    """The fused kernel's positional arguments (B4 / B6 and their plain
    versions take the same): the table, the rows in the pseudo-grid
    frame, their velocities, validity (alive, not in a trailing block)
    and tiles, the pseudo-grid and the coefficients."""
    base = config.base
    return (table, lp0, state.velocity, state.alive & ~bad_block,
            state.tile_id, config.pseudo_shape, config.tiling,
            _qm_half_dt(base), base.dt, base.cell_size, base.charge, base.c,
            base.relativistic)


def _push_deposit(config, table, lp0, state, n_tiles: int):
    """The particle half of a sorted step on a rank's pseudo-grid, from
    its E|B ``table`` and its rows ``lp0`` in the pseudo-grid frame:
    gather, Boris, drift and Esirkepov (one fused kernel, or the windowed
    plain route), with the exact patch of the rows past their window and
    of the trailing blocks' rows (up to ``spill_capacity``).  Returns
    ``(lp1, velocity, coord_v, j_pad, idx, n_spill, d_mask)``: the new
    rows (unwrapped in the frame), the J deposit on the pseudo-grid, the
    patched rows and the count and mask of the rows that needed it."""
    base, tiling = config.base, config.tiling
    ndim, pseudo_shape = base.n_dim, config.pseudo_shape
    alive = state.alive
    dev = alive.device
    dxv = _dxv(config, dev)
    qm_half_dt = _qm_half_dt(base)
    capacity = config.spill_capacity
    # rows of the trailing dead blocks (migrants dropped there) have no
    # window: forced onto the exact patch
    bad_block = state.tile_id >= n_tiles
    if config.gather_backend == "fused":
        substep = fused_em2d_substep if ndim == 2 else fused_em3d_substep
        lp1, velocity, j_pad, in_win = substep(
            *_fused_args(config, table, lp0, state, bad_block),
            precision=config.pallas_precision or "highest")
        d_mask = (~in_win | bad_block) & alive
        n_spill, idx = patch_rows(d_mask, (capacity,))
        if n_spill:
            # re-pushed from the ORIGINAL rows: the kernel freezes the
            # out-of-window rows, and a trailing block's rows come back
            # as given
            pseudo_f = device_const(pseudo_shape, dev)
            lp0_k = torch.remainder(lp0[idx], pseudo_f)
            eb_k = cic_gather_packed(table, lp0_k, pseudo_shape)
            vel_k = boris_kick(state.velocity[idx], eb_k[:, :3],
                               eb_k[:, 3:], qm_half_dt, base.relativistic,
                               base.c)
            cv_k = _coord_velocity(base, vel_k)
            lp1_k = lp0_k + base.dt * cv_k[:, :ndim] / dxv
            j_pad = j_pad + _esirkepov(base, lp0_k, lp1_k, cv_k,
                                       base.charge, pseudo_shape)
            lp1[idx] = lp1_k
            velocity[idx] = vel_k
        velocity = torch.where(alive[:, None], velocity, 0.0)
        coord_v = _coord_velocity(base, velocity)
        return lp1, velocity, coord_v, j_pad, idx, n_spill, d_mask

    gather_fn = gather_sorted_2d if ndim == 2 else gather_sorted_3d
    eb, g_inw = gather_fn(table, lp0, state.tile_id, pseudo_shape, tiling)
    g_mask = (~g_inw | bad_block) & alive
    n_g, g_idx = patch_rows(g_mask, (capacity,))
    if n_g:
        eb[g_idx] = cic_gather_packed(table, lp0[g_idx], pseudo_shape)
    velocity = boris_kick(state.velocity, eb[:, :3], eb[:, 3:], qm_half_dt,
                          base.relativistic, base.c)
    velocity = torch.where(alive[:, None], velocity, 0.0)
    coord_v = _coord_velocity(base, velocity)
    lp1 = lp0 + base.dt * coord_v[:, :ndim] / dxv

    # sorted Esirkepov: trailing-block rows deposit nothing through a
    # clamped window; they take the exact patch with the spilled rows
    q_sorted = torch.where(alive & ~bad_block, base.charge, 0.0).to(
        torch.float32)
    if ndim == 2:
        j_pad, _, d_mask = esirkepov_sorted_2d(
            lp0, lp1, coord_v[:, 2], q_sorted, state.tile_id, base.dt,
            pseudo_shape, base.cell_size, tiling)
    else:
        j_pad, _, d_mask = esirkepov_sorted_3d(
            lp0, lp1, q_sorted, state.tile_id, base.dt, pseudo_shape,
            base.cell_size, tiling)
    d_mask = (d_mask | bad_block) & alive
    n_spill, idx = patch_rows(d_mask, (capacity,))
    if n_spill:
        j_pad = j_pad + _esirkepov(base, lp0[idx], lp1[idx], coord_v[idx],
                                   base.charge, pseudo_shape)
    return lp1, velocity, coord_v, j_pad, idx, n_spill, d_mask


def make_sharded_sorted_step_fn(config: ShardedEMConfig, mesh,
                                axis: str = "space"):
    """The sorted composition (``gather_backend`` 'xla' or 'fused'), 2D3V
    or 3D3V: E|B halos of ``halo_w`` and the centered table, the particle
    substep on the halo-padded pseudo-grid (``_push_deposit``), the apron
    fold, the Yee update with one-cell curl halos, then the wrap back and
    migration (or repair)."""
    _check_backend(config)
    ring = _Ring(config, mesh, axis)
    base = config.base
    groups, n_tiles = (ring.group,), _n_tiles(config)

    def step(state: ShardedEMState) -> ShardedEMState:
        table = _table(base, state.e, state.b, groups,
                       (config.halo_w,))
        lp0 = _to_local(config, state.position, ring.x_lo)
        lp1, velocity, coord_v, j_pad, idx, n_spill, d_mask = _push_deposit(
            config, table, lp0, state, n_tiles)
        max_disp = _max_disp(config, coord_v[:, :base.n_dim],
                             state.max_disp)
        j_local = halo.accumulate_apron(j_pad, ring.group, config.halo_w)
        e_new, b_new = _yee_local(base, state.e, state.b, j_local, groups)
        ok = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        x1, velocity, alive, overflow, extra = _wrap_and_migrate(
            config, ring, state, lp1, velocity, state.alive, state.overflow,
            idx, ok, d_mask, n_tiles)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              e=e_new, b=b_new, overflow=overflow,
                              max_disp=max_disp,
                              **_spill_counts(config, state, n_spill),
                              **extra)

    return step


def _cell_order(config) -> bool:
    """Rows by cell inside each tile where the single-device shell builds
    that order: the fused 2D layout (kernel B4)."""
    return config.gather_backend == "fused" and config.base.n_dim == 2


def make_sharded_resort_fn(config: ShardedEMConfig, mesh,
                           axis: str = "space"):
    """``resort(state) -> state``: this shard's layout rebuilt on its
    pseudo-grid (no communication); rows that fall past the state's
    length count as overflow."""
    ring = _Ring(config, mesh, axis)

    def resort(state: ShardedEMState) -> ShardedEMState:
        return _relayout(config, state,
                         _to_local(config, state.position, ring.x_lo),
                         _cell_order(config))

    return resort


# the repair composition's free-stack builder: the sharded ES model's,
# which works on any sharded sorted state
make_sharded_em_free_init_fn = make_sharded_es_free_init_fn


_EM_DTYPES = dict(
    position=np.float32, velocity=np.float32, alive=np.bool_, e=np.float32,
    b=np.float32, overflow=np.int64, max_disp=np.float32, tile_id=np.int32,
    spill=np.int64, free_idx=np.int64, free_cnt=np.int64,
    spare_idx=np.int64, spare_cnt=np.int64, unplaced=np.int64)


class ShardedElectromagneticPIC(_ShardedShell):
    """Stateful shell of one rank (mirrors ``ElectromagneticPIC``).

    ``mesh`` is a 1D ``DeviceMesh`` (or one with an ``axis`` dimension),
    or the ring's process group; its size must be ``config.n_shards``.
    Every rank passes the same global ``position``/``velocity`` (and
    fields ``e``/``b``, zero by default) and keeps its own slab.  Runs on
    the CUDA card unless given ``device="cpu"``."""

    def __init__(self, config: ShardedEMConfig, mesh, position, velocity,
                 e=None, b=None, axis: str = "space", device=None):
        self.config = config
        if config.repair_eager:
            if not config.repair:
                raise ValueError("repair_eager requires repair=True")
            if config.tiling is None or not (
                    0 < config.repair_eager <= config.tiling.margin):
                raise ValueError(
                    f"repair_eager={config.repair_eager} needs a tiling and "
                    f"must be in 1..margin")
        self.sorted = config.tiling is not None
        if config.repair and not self.sorted:
            raise ValueError("repair=True needs the sorted composition")
        if self.sorted:
            _check_backend(config)
        resolve_precision(config.pallas_precision,
                          getattr(config.tiling, "dtype", "float32"))
        self._attach_ring(config, mesh, axis, device, APRON_W)
        dist_cfg = (dataclasses.replace(config, capacity=config.cap_padded)
                    if self.sorted else config)
        pos, vel, alive = distribute(dist_cfg,
                                     np.asarray(position, np.float32),
                                     np.asarray(velocity, np.float32),
                                     shard=self._shard)
        rows = slice(self._ring.x_lo, self._ring.x_lo + config.slab)

        def field(f):
            if f is None:
                return torch.zeros((config.slab, *config.base.grid_shape[1:],
                                    3), dtype=torch.float32,
                                   device=self.device)
            return torch.as_tensor(np.array(np.asarray(f, np.float32)[rows]),
                                   device=self.device)

        def zeros(dtype):
            return torch.zeros((1,), dtype=dtype, device=self.device)

        self.state = ShardedEMState(
            position=torch.as_tensor(pos, device=self.device),
            velocity=torch.as_tensor(vel, device=self.device),
            alive=torch.as_tensor(alive, device=self.device),
            e=field(e), b=field(b), overflow=zeros(torch.int64),
            max_disp=zeros(torch.float32),
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

    def _make_steps(self, mesh, axis):
        config = self.config
        if not self.sorted:
            self._step = make_sharded_step_fn(config, mesh, axis)
            return
        self._resort = make_sharded_resort_fn(config, mesh, axis)
        if config.repair:
            self._free_init = make_sharded_em_free_init_fn(config, mesh,
                                                           axis)
            self._unplaced_seen = self._overflow_seen = 0
            self._need_resort = False
        self._step = make_sharded_sorted_step_fn(config, mesh, axis)
        self._since_sort = 0

    @classmethod
    def from_state(cls, config: ShardedEMConfig, mesh, blob: dict,
                   axis: str = "space", device=None
                   ) -> "ShardedElectromagneticPIC":
        """A shell on a given state, with no initial resort: ``blob``
        holds the reference's global state as numpy arrays (``{k:
        np.asarray(v) for k, v in sim.state._asdict().items() if v is not
        None}``), and this rank takes its shard's rows and its slab of the
        fields.  Both packages then step from one layout, row for row."""
        self = cls.__new__(cls)
        self.config = config
        self.sorted = config.tiling is not None
        self._attach_ring(config, mesh, axis, device, APRON_W)
        x_lo = self._ring.x_lo
        self.state = self._blob_state(
            ShardedEMState, blob, fields=("e", "b"),
            field_blocks=slice(x_lo, x_lo + config.slab), **_EM_DTYPES)
        if self.sorted:
            self.state = self.state._replace(spill_dropped=torch.zeros(
                (1,), dtype=torch.int64, device=self.device))
        self._make_steps(mesh, axis)
        if config.repair:
            self._unplaced_seen = int(blob["unplaced"].sum())
            self._overflow_seen = int(blob["overflow"].sum())
        return self

    def fused_substep_args(self) -> tuple:
        """The positional arguments the fused backend hands its kernel (B4
        / B6, and their plain versions) at the current state: the E|B
        table on the shard's halo-padded pseudo-grid, the rows in its
        frame, their velocities, validity and tiles, the pseudo-grid's
        shape and the coefficients."""
        config, st = self.config, self.state
        table = _table(config.base, st.e, st.b, self._groups,
                       (config.halo_w,))
        return _fused_args(config, table,
                           _to_local(config, st.position, self._ring.x_lo),
                           st, st.tile_id >= _n_tiles(config))
