"""Electromagnetic PIC (Yee FDTD + Boris + Esirkepov) on a two-axis
spatial mesh (port of ``fusion_sim_tpu/models/electromagnetic_sharded2d.py``).

The two-axis counterpart of ``models/electromagnetic_sharded.py``: the
grid splits over both leading axes on a ``DeviceMesh`` of shape (Sx, Sy)
with dimensions ("sx", "sy").  There is no global solve: every phase of
the step exchanges with mesh neighbours only.  One step, on the rank's
block:

    field halos        (with_halo on x, then y: corners ride two hops)
    -> gather + Boris kick + drift
    -> Esirkepov current deposit into the two-axis apron-padded block
    -> accumulate_apron_2d
    -> Yee leapfrog (B half, E full, B half), each curl over a one-cell
       halo on both axes
    -> migrate_grid    (x phase, then y phase; diagonal crossers in two)

The sorted compositions (a ``tiling``) run on the pseudo-grid padded on
both decomposed axes; ``gather_backend='fused'`` launches B4
(``ops/fused_em.fused_em2d_substep``) in 2D3V and B6
(``ops/fused_em3d.fused_em3d_substep``) in 3D3V on it, with the exact
patch of the 1-axis model (``electromagnetic_sharded._push_deposit``).
The fused 2D layout orders each tile's rows by cell, for B4.  The mesh's
groups, the frame shift and the migration are the two-axis ES model's
(``models/electrostatic_sharded2d.py``).  Every entry point runs on the
CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import device_const
from ..ops.interp import cic_gather_packed
from ..ops.precision import resolve_precision
from ..parallel import halo
from .electromagnetic import EMConfig, boris_kick
from .electromagnetic_sharded import (_EM_DTYPES, APRON_W, HALO_W,
                                      ShardedEMState, _cell_order,
                                      _check_backend, _esirkepov,
                                      _fused_args, _push_deposit,
                                      _qm_half_dt, _table, _yee_local)
from .electrostatic_sharded import (_dxv, _max_disp, _n_tiles, _relayout,
                                    _spill_counts)
from .electrostatic_sharded2d import (_make_grid_mig, _make_to_local_2d,
                                      _Mesh2D, _Mesh2DShell, _shift_xy,
                                      _wrap_back_2d, distribute_2d)


@dataclasses.dataclass(frozen=True)
class ShardedEMConfig2D:
    """The two-axis decomposition (mesh axes "sx" x "sy" over grid axes 0
    and 1)."""

    base: EMConfig
    mesh_shape: tuple[int, int]
    capacity: int
    migration_buffer: int
    # sorted compositions (tiling != None): per-shard tile-sorted padded
    # particles on a pseudo-grid padded on both decomposed axes
    tiling: object | None = None
    resort_every: int = 6
    spill_capacity: int = 16384
    # sorted compositions only: 'fused' runs each shard's gather + Boris +
    # drift + Esirkepov in one kernel (B4 in 2D3V, B6 in 3D3V)
    gather_backend: str = "xla"
    pallas_precision: str | None = None
    debug_checks: bool = False

    @property
    def n_shards(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]

    @property
    def tile_xy(self) -> tuple[int, int]:
        t = self.tiling
        return ((t.tile_r, t.tile_z) if self.base.n_dim == 2
                else (t.tile[0], t.tile[1]))

    @property
    def halo_ws(self) -> tuple[int, int]:
        """The sorted compositions' halo and apron width on each
        decomposed axis: whole tiles covering the gather window's reach
        and the Esirkepov apron, and at least 2*margin + 1 cells."""
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
            if s_a > 1 and slab < APRON_W:
                raise ValueError(f"block width {slab} on axis {a} < "
                                 f"deposition apron {APRON_W}")
            out.append(slab)
        return tuple(out)

    @property
    def disp_bound(self) -> float:
        bound = float(APRON_W - 2)  # the Esirkepov 3-node stencil's reach
        for a in range(2):
            if self.mesh_shape[a] > 1:
                bound = min(bound, self.slabs[a] / 2.0)
        return bound


def make_sharded_em_step_fn_2d(config: ShardedEMConfig2D, mesh,
                               axes: tuple[str, str] = ("sx", "sy")):
    """``step(state) -> state`` of the plain (unsorted) composition on the
    two-axis mesh, on this rank's block."""
    m2 = _Mesh2D(config, mesh, axes)
    base = config.base
    ndim, rest = base.n_dim, base.grid_shape[2:]
    slab_x, slab_y = config.slabs
    pad_shape = (slab_x + 2 * APRON_W, slab_y + 2 * APRON_W, *rest)
    halo_shape = (slab_x + 2 * HALO_W, slab_y + 2 * HALO_W, *rest)
    migrate = _make_grid_mig(config, m2)
    x_lo, y_lo = m2.lows

    def step(state: ShardedEMState) -> ShardedEMState:
        position, alive = state.position, state.alive
        # ---- field halos, gather, push -----------------------------------
        table = _table(base, state.e, state.b, m2.groups, (HALO_W, HALO_W))
        eb = cic_gather_packed(
            table, _shift_xy(position, HALO_W - x_lo, HALO_W - y_lo),
            halo_shape)
        velocity = boris_kick(state.velocity, eb[:, :3], eb[:, 3:],
                              _qm_half_dt(base), base.relativistic, base.c)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        # unwrapped until after deposition (Esirkepov reads x0 -> x1)
        x1 = position + base.dt * velocity[:, :ndim] / _dxv(
            config, position.device)
        max_disp = _max_disp(config, velocity[:, :ndim], state.max_disp)

        # ---- deposit into the two-axis padded block, fold, Yee -----------
        charge = torch.where(alive, base.charge, 0.0).to(torch.float32)
        j_pad = _esirkepov(
            base, _shift_xy(position, APRON_W - x_lo, APRON_W - y_lo),
            _shift_xy(x1, APRON_W - x_lo, APRON_W - y_lo), velocity, charge,
            pad_shape)
        j_local = halo.accumulate_apron_2d(j_pad, m2.groups,
                                           (APRON_W, APRON_W))
        e_new, b_new = _yee_local(base, state.e, state.b, j_local,
                                  m2.groups)

        # ---- wrap + dimension-ordered migration --------------------------
        x1 = torch.remainder(x1, device_const(base.grid_shape, x1.device))
        (x1, velocity), alive, overflow = migrate((x1, velocity), alive,
                                                  state.overflow)
        x1 = torch.where(alive[:, None], x1, 0.0)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              e=e_new, b=b_new, overflow=overflow,
                              max_disp=max_disp)

    return step


def make_sharded_sorted_em_step_fn_2d(config: ShardedEMConfig2D, mesh,
                                      axes: tuple[str, str] = ("sx", "sy")):
    """The sorted composition (``gather_backend`` 'xla' or 'fused') on the
    two-axis mesh: E|B halos of ``halo_ws`` and the centered table, the
    particle substep on the pseudo-grid, the two-axis apron fold, the Yee
    update with one-cell curl halos on both axes, then the wrap back and
    the dimension-ordered migration."""
    _check_backend(config)
    m2 = _Mesh2D(config, mesh, axes)
    base = config.base
    n_tiles = _n_tiles(config)
    to_local = _make_to_local_2d(config)
    migrate = _make_grid_mig(config, m2)

    def step(state: ShardedEMState) -> ShardedEMState:
        table = _table(base, state.e, state.b, m2.groups, config.halo_ws)
        lp0 = to_local(state.position, *m2.lows)
        lp1, velocity, coord_v, j_pad, _, n_spill, _ = _push_deposit(
            config, table, lp0, state, n_tiles)
        max_disp = _max_disp(config, coord_v[:, :base.n_dim],
                             state.max_disp)
        j_local = halo.accumulate_apron_2d(j_pad, m2.groups, config.halo_ws)
        e_new, b_new = _yee_local(base, state.e, state.b, j_local,
                                  m2.groups)
        (x1, velocity), alive, overflow = migrate(
            (_wrap_back_2d(config, m2, lp1), velocity), state.alive,
            state.overflow)
        x1 = torch.where(alive[:, None], x1, 0.0)
        velocity = torch.where(alive[:, None], velocity, 0.0)
        return state._replace(position=x1, velocity=velocity, alive=alive,
                              e=e_new, b=b_new, overflow=overflow,
                              max_disp=max_disp,
                              **_spill_counts(config, state, n_spill))

    return step


def make_sharded_em_resort_fn_2d(config: ShardedEMConfig2D, mesh,
                                 axes: tuple[str, str] = ("sx", "sy")):
    """``resort(state) -> state``: this shard's layout rebuilt in its
    two-axis pseudo-grid frame (no communication; rows by cell inside each
    tile on the fused 2D layout, for B4)."""
    m2 = _Mesh2D(config, mesh, axes)
    to_local = _make_to_local_2d(config)

    def resort(state: ShardedEMState) -> ShardedEMState:
        return _relayout(config, state, to_local(state.position, *m2.lows),
                         _cell_order(config))

    return resort


class ShardedElectromagneticPIC2D(_Mesh2DShell):
    """Stateful shell of one rank on the two-axis mesh (mirrors
    ``ShardedElectromagneticPIC``).

    ``mesh`` is a ``DeviceMesh`` of shape ``config.mesh_shape`` with the
    dimensions ``axes``.  Every rank passes the same global
    ``position``/``velocity`` (and fields ``e``/``b``, zero by default)
    and keeps its own block.  Runs on the CUDA card unless given
    ``device="cpu"``."""

    def __init__(self, config: ShardedEMConfig2D, mesh, position, velocity,
                 e=None, b=None, axes: tuple[str, str] = ("sx", "sy"),
                 device=None):
        self.config = config
        self.sorted = config.tiling is not None
        if self.sorted:
            _check_backend(config)
        resolve_precision(config.pallas_precision,
                          getattr(config.tiling, "dtype", "float32"))
        self._attach_mesh(config, mesh, axes, device, APRON_W)
        base = config.base
        dist_cfg = (dataclasses.replace(config, capacity=config.cap_padded)
                    if self.sorted else config)
        pos, vel, alive = distribute_2d(dist_cfg,
                                        np.asarray(position, np.float32),
                                        np.asarray(velocity, np.float32),
                                        shard=self._shard)
        blocks = self._blocks()

        def field(f):
            if f is None:
                return torch.zeros((*config.slabs, *base.grid_shape[2:], 3),
                                   dtype=torch.float32, device=self.device)
            return torch.as_tensor(np.array(np.asarray(f, np.float32)[blocks]),
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
        self._make_steps(mesh, axes)
        if self.sorted:
            self.state = self._resort(self.state)

    def _make_steps(self, mesh, axes):
        if not self.sorted:
            self._step = make_sharded_em_step_fn_2d(self.config, mesh, axes)
            return
        self._resort = make_sharded_em_resort_fn_2d(self.config, mesh, axes)
        self._step = make_sharded_sorted_em_step_fn_2d(self.config, mesh,
                                                       axes)
        self._since_sort = 0

    @classmethod
    def from_state(cls, config: ShardedEMConfig2D, mesh, blob: dict,
                   axes: tuple[str, str] = ("sx", "sy"), device=None
                   ) -> "ShardedElectromagneticPIC2D":
        """A shell on a given state, with no initial resort: ``blob`` holds
        the reference's global state as numpy arrays, and this rank takes
        its shard's rows and its block of the fields."""
        self = cls.__new__(cls)
        self.config = config
        self.sorted = config.tiling is not None
        self._attach_mesh(config, mesh, axes, device, APRON_W)
        self.state = self._blob_state(ShardedEMState, blob,
                                      fields=("e", "b"),
                                      field_blocks=self._blocks(),
                                      **_EM_DTYPES)
        if self.sorted:
            self.state = self.state._replace(spill_dropped=torch.zeros(
                (1,), dtype=torch.int64, device=self.device))
        self._make_steps(mesh, axes)
        return self

    def fused_substep_args(self) -> tuple:
        """The positional arguments the fused backend hands its kernel (B4
        / B6, and their plain versions) at the current state, on the
        shard's two-axis pseudo-grid."""
        config, st = self.config, self.state
        table = _table(config.base, st.e, st.b, self._m2.groups,
                       config.halo_ws)
        lp0 = _make_to_local_2d(config)(st.position, *self._m2.lows)
        return _fused_args(config, table, lp0, st,
                           st.tile_id >= _n_tiles(config))
