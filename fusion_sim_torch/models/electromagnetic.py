"""Electromagnetic particle-in-cell model (Yee FDTD + Esirkepov, 2D3V/3D).

Port of ``fusion_sim_tpu/models/electromagnetic.py``.  The
charge-conserving electromagnetic PIC loop:

    1. Boris velocity kick with E, B gathered at x^n (CIC)
    2. drift x^n -> x^{n+1}
    3. Esirkepov current deposition from the motion (keeps Gauss's law)
    4. Yee field update: B half, E full (with J), B half

Units: natural (c = eps0 = mu0 = 1).  Fields live on the staggered Yee
lattice packed (*grid, 3); positions in grid units; velocities physical.
Non-relativistic Boris by default; ``relativistic=True`` switches the kick
to the gamma-corrected form (velocity then stores u = gamma v).

``SortedElectromagneticPIC(gather_backend='fused')`` is the main path:
particles live in the padded tile-sorted layout, and one fused kernel per
step does gather + kick + drift + deposit (ops/fused_em.py in 2D,
ops/fused_em3d.py in 3D) before the Yee update; ``repair=True`` relocates
spilled rows into their new tile every step (ops/repair.py).

The reference's ``jit``/``lax.scan``/``lax.cond`` become plain Python
control flow; step and spill counters are Python ints.  Every entry point
runs on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import device_const, resolve_device
from ..ops import fdtd, node_table2d, node_table3d, yee2d, yee3d
from ..ops.esirkepov import esirkepov_deposit_2d, esirkepov_deposit_3d
from ..ops.fused_em import fused_em2d_substep
from ..ops.fused_em3d import fused_em3d_substep
from ..ops.interp import cic_deposit, cic_gather_packed, patch_rows
from ..ops.sorted_deposit import (esirkepov_sorted_2d, esirkepov_sorted_3d,
                                  gather_sorted_2d, gather_sorted_3d)
from ..ops.sorted_gather import gather_sorted_2d_window
from ..utils.profiling import span
from ._sorted_shell import SortedShell


class EMState(NamedTuple):
    position: torch.Tensor   # (N, d) grid units, d = 2 or 3
    velocity: torch.Tensor   # (N, 3) physical (c = 1)
    e: torch.Tensor          # (*grid, 3)
    b: torch.Tensor          # (*grid, 3)
    step: int


@dataclasses.dataclass(frozen=True)
class EMConfig:
    grid_shape: tuple[int, ...]
    cell_size: tuple[float, ...]
    dt: float
    charge: float
    mass: float
    c: float = 1.0
    eps0: float = 1.0
    relativistic: bool = False
    # 'staggered': exact Yee-point gathers (6 gather rows/particle);
    # 'centered': fields averaged to nodes once per step, one 6-channel
    # gather row/particle (the uniform-centering fast variant).
    field_gather: str = "staggered"
    # Process particles in this many sequential chunks per step, with a
    # current accumulator, to bound the gather/deposit intermediates.
    particle_chunks: int = 1

    @property
    def n_dim(self) -> int:
        return len(self.grid_shape)

    @property
    def cell_volume(self) -> float:
        return math.prod(self.cell_size)

    def __post_init__(self):
        # Courant condition for Yee + the Esirkepov < 1-cell-per-step support
        inv2 = sum(1.0 / d**2 for d in self.cell_size)
        courant = self.c * self.dt * math.sqrt(inv2)
        if courant >= 1.0:
            raise ValueError(f"Yee CFL violated: c*dt*sqrt(sum 1/dx^2) = "
                             f"{courant:.3f} >= 1")


def _offsets(config: EMConfig):
    """(E, B) Yee offsets of the config's dimension."""
    if config.n_dim == 2:
        return fdtd.E_OFFSETS_2D, fdtd.B_OFFSETS_2D
    return fdtd.E_OFFSETS_3D, fdtd.B_OFFSETS_3D


def _deposit(config: EMConfig, x0, x1, coord_v, charge):
    """The exact Esirkepov deposit of the config's dimension for rows
    moving x0 -> x1 (unwrapped); ``coord_v`` gives the 2D3V z-current."""
    if config.n_dim == 2:
        return esirkepov_deposit_2d(x0, x1, coord_v[:, 2], charge, config.dt,
                                    config.grid_shape, config.cell_size)
    return esirkepov_deposit_3d(x0, x1, charge, config.dt, config.grid_shape,
                                config.cell_size)


def _gamma(velocity: torch.Tensor, c: float) -> torch.Tensor:
    return torch.sqrt(1.0 + torch.sum((velocity / c) ** 2, dim=-1,
                                      keepdim=True))


def boris_kick(velocity: torch.Tensor, e: torch.Tensor, b: torch.Tensor,
               qm_half_dt: float, relativistic: bool,
               c: float) -> torch.Tensor:
    """Standard Boris rotation kick: half E, full B rotation, half E."""
    v_minus = velocity + qm_half_dt * e
    if relativistic:
        t = qm_half_dt * b / _gamma(v_minus, c)
    else:
        t = qm_half_dt * b
    t2 = torch.sum(t * t, dim=-1, keepdim=True)
    s = 2.0 * t / (1.0 + t2)
    v_prime = v_minus + torch.linalg.cross(v_minus, t)
    v_plus = v_minus + torch.linalg.cross(v_prime, s)
    return v_plus + qm_half_dt * e


def _coord_velocity(config: EMConfig, velocity: torch.Tensor) -> torch.Tensor:
    """The drift velocity: velocity stores the proper velocity u = gamma v
    when relativistic, and the coordinate drift uses v = u/gamma (keeps
    |v| < c and the Esirkepov < 1-cell-per-step support)."""
    if config.relativistic:
        return velocity / _gamma(velocity, config.c)
    return velocity


def yee_update(config: EMConfig, e, b, j):
    """``(e_new, b_new)``: B half step, E full step with J, B half step.
    3D goes through ``yee3d.yee_update_3d``, 2D through
    ``yee2d.yee_update_2d`` (one kernel launch on the card each, the rolls
    and differences on the CPU)."""
    update = (yee3d.yee_update_3d if config.n_dim == 3
              else yee2d.yee_update_2d)
    return update(e, b, j, config.dt, config.cell_size, config.c,
                  config.eps0)


def check_step_config(config: EMConfig) -> None:
    """Raises unless the plain step supports ``config`` (2D3V or 3D, a
    known ``field_gather``)."""
    if config.n_dim not in (2, 3):
        raise ValueError("the EM model is 2D3V or 3D")
    if config.field_gather not in ("staggered", "centered"):
        raise ValueError(f"field_gather {config.field_gather!r} "
                         f"(staggered|centered)")


def node_table(config: EMConfig, e, b):
    """The node-centered (*grid, 6) E|B table.  3D goes through
    ``node_table3d.node_table_3d``, 2D through ``node_table2d.node_table_2d``
    (one kernel launch on the card each, ``center_fields`` on the CPU)."""
    if config.n_dim == 3:
        return node_table3d.node_table_3d(e, b)
    return node_table2d.node_table_2d(e, b)


def field_table(config: EMConfig, e, b):
    """``node_table`` for ``'centered'`` gathers, or None for
    ``'staggered'`` (the exact Yee-point gathers)."""
    if config.field_gather != "centered":
        return None
    return node_table(config, e, b)


def push_and_deposit(config: EMConfig, e_field, b_field, position, velocity,
                     table=None):
    """Gather -> kick -> drift -> deposit for one particle batch on the
    full grid: ``(x1, velocity', j)`` with x1 wrapped and j the batch's
    Esirkepov current.  ``table`` is ``field_table``'s (once a step for
    every batch).  The step sums j over its ``particle_chunks``; the
    data-parallel step (``parallel/sharding.py``) over ranks."""
    shape = config.grid_shape
    dev = position.device
    if table is not None:
        eb = cic_gather_packed(table, position, shape)  # (N, 6)
        e_at_p, b_at_p = eb[:, :3], eb[:, 3:]
    else:
        e_off, b_off = _offsets(config)
        e_at_p = fdtd.gather_staggered(e_field, position, e_off, shape)
        b_at_p = fdtd.gather_staggered(b_field, position, b_off, shape)
    qm_half_dt = config.charge / config.mass * config.dt * 0.5
    velocity = boris_kick(velocity, e_at_p, b_at_p, qm_half_dt,
                          config.relativistic, config.c)
    coord_v = _coord_velocity(config, velocity)
    dxv = device_const(config.cell_size, dev)
    grid_f = device_const(shape, dev)
    x1_unwrapped = position + config.dt * coord_v[:, :config.n_dim] / dxv
    j = _deposit(config, position, x1_unwrapped, coord_v, config.charge)
    return torch.remainder(x1_unwrapped, grid_f), velocity, j


def make_step_fn(config: EMConfig):
    check_step_config(config)
    shape = config.grid_shape

    def step(state: EMState) -> EMState:
        chunks = max(config.particle_chunks, 1)
        n = state.position.shape[0]
        if n % chunks:
            raise ValueError(f"N={n} not divisible by "
                             f"particle_chunks={chunks}")
        table = field_table(config, state.e, state.b)
        j = torch.zeros((*shape, 3), dtype=torch.float32,
                        device=state.position.device)
        x1, velocity = [], []
        for pos_c, vel_c in zip(state.position.chunk(chunks),
                                state.velocity.chunk(chunks)):
            x1_c, v_c, j_c = push_and_deposit(config, state.e, state.b,
                                              pos_c, vel_c, table)
            j = j + j_c
            x1.append(x1_c)
            velocity.append(v_c)
        e_new, b_new = yee_update(config, state.e, state.b, j)
        return EMState(position=torch.cat(x1), velocity=torch.cat(velocity),
                       e=e_new, b=b_new, step=state.step + 1)

    return step


def charge_density(config: EMConfig, position: torch.Tensor) -> torch.Tensor:
    w = torch.full((position.shape[0],), config.charge / config.cell_volume,
                   dtype=torch.float32, device=position.device)
    return cic_deposit(position, w, config.grid_shape)


def yee_divergence(config: EMConfig, e: torch.Tensor) -> torch.Tensor:
    """div_Yee E at the nodes (backward differences of the staggered E)."""
    div = torch.zeros(config.grid_shape, dtype=torch.float32, device=e.device)
    for axis, d in enumerate(config.cell_size):
        comp = e[..., axis]
        div = div + (comp - torch.roll(comp, 1, axis)) / d
    return div


def gauss_residual(config: EMConfig, state: EMState,
                   background_rho: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """div_Yee E - rho/eps0 over the grid — stays at roundoff for all time
    with Esirkepov deposition (the point of charge conservation)."""
    rho = charge_density(config, state.position)
    if background_rho is not None:
        rho = rho + background_rho
    return yee_divergence(config, state.e) - rho / config.eps0


def _field_energy(config: EMConfig, e, b) -> torch.Tensor:
    mu0 = 1.0 / (config.eps0 * config.c**2)
    return (0.5 * config.eps0 * torch.sum(e**2)
            + 0.5 / mu0 * torch.sum(b**2)) * config.cell_volume


def field_energy(config: EMConfig, state) -> torch.Tensor:
    """(eps0/2)|E|^2 + |B|^2/(2 mu0), mu0 = 1/(eps0 c^2)."""
    return _field_energy(config, state.e, state.b)


def kinetic_energy(config: EMConfig, state) -> torch.Tensor:
    """Of every row of ``state.velocity`` (zero rows add nothing)."""
    if config.relativistic:
        # velocity stores proper velocity u = gamma*v; KE = m c^2 (gamma - 1)
        gamma = _gamma(state.velocity, config.c)
        return config.mass * config.c**2 * torch.sum(gamma - 1.0)
    return 0.5 * config.mass * torch.sum(state.velocity**2)


def _fields_from(blob_or_none, shape, dev):
    if blob_or_none is None:
        return torch.zeros((*shape, 3), dtype=torch.float32, device=dev)
    return torch.tensor(np.asarray(blob_or_none, np.float32), device=dev)


def em_state_from_numpy(blob: dict, device=None) -> EMState:
    """An ``EMState`` from the reference's state as numpy arrays
    (``{k: np.asarray(v) for k, v in jax_model.state._asdict().items()}``)."""
    dev = resolve_device(device)

    def t(key):
        return torch.tensor(np.asarray(blob[key], np.float32), device=dev)

    return EMState(position=t("position"), velocity=t("velocity"), e=t("e"),
                   b=t("b"), step=int(blob.get("step", 0)))


class ElectromagneticPIC:
    """Stateful shell over the functional EM PIC core."""

    def __init__(self, config: EMConfig, position, velocity, e=None, b=None,
                 device=None):
        self.config = config
        dev = resolve_device(device)
        n = np.asarray(position).shape[0]
        shape = config.grid_shape
        self.state = EMState(
            position=torch.tensor(np.asarray(position, np.float32)
                                  .reshape(n, config.n_dim), device=dev),
            velocity=torch.tensor(np.asarray(velocity, np.float32)
                                  .reshape(n, 3), device=dev),
            e=_fields_from(e, shape, dev), b=_fields_from(b, shape, dev),
            step=0)
        self._step = make_step_fn(config)

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self.state = self._step(self.state)

    def energies(self) -> dict[str, float]:
        fe = float(field_energy(self.config, self.state))
        ke = float(kinetic_energy(self.config, self.state))
        return {"field": fe, "kinetic": ke, "total": fe + ke}

    def get_state(self) -> dict[str, np.ndarray]:
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in self.state._asdict().items()}

    def set_state(self, blob: dict[str, np.ndarray]) -> None:
        self.state = em_state_from_numpy(blob, self.state.position.device)


# ---------------------------------------------------------------------------
# Sorted-layout variant (2D3V and 3D): the fused-kernel main path
# ---------------------------------------------------------------------------

class SortedEMState(NamedTuple):
    """Padded tile-sorted EM layout (fillers: valid=False, charge 0)."""

    position: torch.Tensor   # (Npad, d), d = 2 or 3
    velocity: torch.Tensor   # (Npad, 3)
    tile_id: torch.Tensor    # (Npad,) int32, tile at last resort
    valid: torch.Tensor      # (Npad,) bool
    e: torch.Tensor
    b: torch.Tensor
    step: int
    spill: int               # cumulative out-of-window rows
    spill_dropped: int       # cumulative rows past spill_capacity (their
                             # deposits are lost even with the fallback on)
    # incremental layout repair (repair=True) only:
    free_idx: torch.Tensor | None = None  # (n_tiles, F) dead-slot stacks
    free_cnt: torch.Tensor | None = None  # (n_tiles,)
    unplaced: torch.Tensor | None = None  # cumulative spills left in place
                                          # (no free slot), on the device


def sorted_em_state_from_numpy(blob: dict, device=None) -> SortedEMState:
    """A ``SortedEMState`` from the reference's sorted state as numpy
    arrays (``{k: np.asarray(v) for k, v in jax_model.state._asdict()
    .items() if v is not None}``): both packages then share one layout."""
    dev = resolve_device(device)

    def t(key, dtype):
        if blob.get(key) is None:
            return None
        return torch.tensor(np.asarray(blob[key], dtype), device=dev)

    return SortedEMState(
        position=t("position", np.float32), velocity=t("velocity", np.float32),
        tile_id=t("tile_id", np.int32), valid=t("valid", np.bool_),
        e=t("e", np.float32), b=t("b", np.float32),
        step=int(blob.get("step", 0)), spill=int(blob.get("spill", 0)),
        spill_dropped=int(blob.get("spill_dropped", 0)),
        free_idx=t("free_idx", np.int64), free_cnt=t("free_cnt", np.int64),
        unplaced=t("unplaced", np.int64))


class SortedElectromagneticPIC(SortedShell):
    """EM PIC (2D3V or 3D) on the tile-sorted layout.

    Physics identical to ``ElectromagneticPIC(field_gather='centered')``.
    Same layout / resort contract as ``SortedElectrostaticPIC``: the shell
    resorts every ``resort_every`` steps, and rows that out-drift their
    window anyway are patched exactly, up to ``spill_capacity`` a step.

    ``gather_backend``: 'fused' runs the whole particle substep (gather +
    Boris kick + drift + Esirkepov deposit) in one kernel
    (ops/fused_em.py in 2D, ops/fused_em3d.py in 3D); 'pallas' routes the
    2D field gather through the windowed gather kernel
    (ops/sorted_gather.py) and deposits with ``esirkepov_sorted_2d``; 'xla'
    does the same on ``gather_sorted_2d``.  In 3D (a ``Tiling3D``) 'xla'
    runs ``gather_sorted_3d`` and ``esirkepov_sorted_3d``, and 'pallas'
    takes the same route, as in the reference: the windowed gather kernel
    is 2D only.  Constructor arguments, validation and defaults are the
    reference's.  ``repair=True`` (on every gather backend) relocates the
    spilled rows into dead slots of their new tile each step, with
    ``repair_free_slots``, ``repair_eager`` and ``eager_capacity`` as in
    ``SortedElectrostaticPIC``; the resort then runs at the start of each
    ``resort_every`` window or when the free stacks drain.  With 'fused' in
    2D the layout orders each tile's rows by cell
    (``build_padded_layout(cell_order=True)``), at build and at every
    resort, so that kernel B4 sums a warp's rows of one cell before it adds
    them to its window.  With 'fused' in 3D and repair off, kernel B6
    writes the fillers as zeros itself, and the finish zeroes nothing.

    ``step`` opens the spans of ``utils/profiling.span``, a profiler's
    annotations while one records, else the host clock's phases
    (``fusion_sim.step`` around the call; leaf phases ``fields``,
    ``kernel``, ``patch``, ``repair``, ``solve``, ``finish``, ``resort`` and
    ``drain_check``, which hold every operation a step launches, with
    ``host_read`` inside ``patch`` around each read of a spill count), and
    while a profiler records counts ``rows_patched``, the rows of a step
    that took the exact patch.
    """

    # Without repair a whole window resorts at its end at any
    # resort_every, where the reference stops at 128 (its compiled-window
    # limit) and resorts at the start of the next call: ROADMAP, Known
    # differences, "Resort cadence"
    _whole_window = math.inf

    def __init__(self, config: EMConfig, position, velocity,
                 e=None, b=None, tiling=None, resort_every: int = 6,
                 check_spill: bool = True, spill_fallback: bool = True,
                 spill_capacity: int = 16384, gather_backend: str = "xla",
                 pallas_precision: str | None = None, repair: bool = False,
                 repair_free_slots: int = 256, repair_eager: int = 0,
                 eager_capacity: int | None = None, device=None):
        self._configure(config, tiling, resort_every, check_spill,
                        spill_fallback, spill_capacity, gather_backend,
                        pallas_precision, repair, repair_free_slots,
                        repair_eager, eager_capacity, device)
        shape = config.grid_shape
        self.state = SortedEMState(
            **self._initial_layout(position, velocity, 3),
            e=_fields_from(e, shape, self.device),
            b=_fields_from(b, shape, self.device))
        self._finish_state()

    _state_from_numpy = staticmethod(sorted_em_state_from_numpy)

    def _configure(self, config, tiling, resort_every, check_spill,
                   spill_fallback, spill_capacity, gather_backend,
                   pallas_precision, repair, repair_free_slots, repair_eager,
                   eager_capacity, device):
        if config.n_dim not in (2, 3):
            raise ValueError("the sorted EM model is 2D3V or 3D")
        if gather_backend not in ("xla", "pallas", "fused"):
            raise ValueError(
                f"gather_backend {gather_backend!r} (xla|pallas|fused)")
        if gather_backend != "xla" and not spill_fallback:
            # the kernels' values for out-of-window rows are not meaningful;
            # the exact patch is what bounds them
            raise ValueError(
                f"gather_backend={gather_backend!r} requires spill_fallback")
        self.gather_backend = gather_backend
        self._configure_layout(config, tiling, resort_every, check_spill,
                               spill_fallback, spill_capacity, None, repair,
                               repair_free_slots, repair_eager,
                               eager_capacity, pallas_precision, device)
        self._consts = (config.charge / config.mass * config.dt * 0.5,
                        device_const(config.cell_size, self.device),
                        device_const(config.grid_shape, self.device))
        self._step_once = (self._step_fused if gather_backend == "fused"
                           else self._step_split)
        self._cell_order = gather_backend == "fused" and config.n_dim == 2
        # kernel B6 writes the fillers of real tiles as +0.0 and returns the
        # sentinel blocks (zero by the layout) as given; without repair no
        # step makes a row invalid, so no zeroing pass is left to do
        self._fillers_zero = (gather_backend == "fused" and config.n_dim == 3
                              and not repair)

    def _finish(self, state, x1, velocity, j, spill, **extra) -> None:
        """The Yee update, fillers zeroed (on the validity after any
        relocation) unless the kernel wrote them as zeros, counters
        advanced."""
        with span("solve"):
            e_new, b_new = yee_update(self.config, state.e, state.b, j)
        with span("finish"):
            if not self._fillers_zero:
                valid = extra.get("valid", state.valid)[:, None]
                x1 = torch.where(valid, x1, 0.0)
                velocity = torch.where(valid, velocity, 0.0)
            self.state = state._replace(
                position=x1, velocity=velocity, e=e_new, b=b_new,
                **self._advanced(state, spill), **extra)

    def _step_fused(self) -> None:
        """One kernel covers gather + kick + drift + Esirkepov; the Yee
        update and the compacted exact spill patch stay in PyTorch."""
        config, state = self.config, self.state
        shape = config.grid_shape
        qm_half_dt, dxv, grid_f = self._consts
        with span("fields"):
            table = node_table(config, state.e, state.b)
        substep = (fused_em2d_substep if config.n_dim == 2
                   else fused_em3d_substep)
        with span("kernel"):
            x1, velocity, j, in_win = substep(
                table, state.position, state.velocity, state.valid,
                state.tile_id, shape, self.tiling, qm_half_dt, config.dt,
                config.cell_size, config.charge, c_light=config.c,
                relativistic=config.relativistic,
                precision=self.pallas_precision or "highest")
        # exact re-push + deposit of out-of-window rows, from their inputs
        with span("patch"):
            spill_mask = ~in_win & state.valid
            spill, idx = patch_rows(spill_mask, self._capacities())
            x1w_k = vel_k = None
            if idx.numel():
                x0_k = torch.remainder(state.position[idx], grid_f)
                eb_k = cic_gather_packed(table, x0_k, shape)
                vel_k = boris_kick(state.velocity[idx], eb_k[:, :3],
                                   eb_k[:, 3:], qm_half_dt,
                                   config.relativistic, config.c)
                cv_k = _coord_velocity(config, vel_k)
                x1_k = x0_k + config.dt * cv_k[:, :config.n_dim] / dxv
                j = j + _deposit(config, x0_k, x1_k, cv_k, config.charge)
                x1w_k = torch.remainder(x1_k, grid_f)
                if not self.repair:
                    x1[idx] = x1w_k
                    velocity[idx] = vel_k
            unspilled = ~spill_mask
        x1, velocity, extra = self._relocated(state, x1, velocity, idx,
                                              x1w_k, vel_k, unspilled)
        self._finish(state, x1, velocity, j, spill, **extra)

    def _step_split(self) -> None:
        """Windowed gather (the kernel for 'pallas', plain for 'xla'),
        Boris and drift in PyTorch, sorted Esirkepov deposit; rows past
        the sort margin get the exact gather and deposit."""
        config, state = self.config, self.state
        shape = config.grid_shape
        qm_half_dt, dxv, grid_f = self._consts
        ndim = config.n_dim
        with span("fields"):
            table = node_table(config, state.e, state.b)
        with span("kernel"):
            if self.gather_backend == "pallas" and ndim == 2:
                eb, g_inw = gather_sorted_2d_window(
                    table, state.position, state.tile_id, shape, self.tiling,
                    "cic", precision=self.pallas_precision or "highest")
            else:
                gather = gather_sorted_2d if ndim == 2 else gather_sorted_3d
                eb, g_inw = gather(table, state.position, state.tile_id,
                                   shape, self.tiling)
        if self.spill_fallback:
            with span("patch"):
                _, g_idx = patch_rows(~g_inw & state.valid,
                                      self._capacities())
                if g_idx.numel():
                    eb[g_idx] = cic_gather_packed(
                        table, torch.remainder(state.position[g_idx], grid_f),
                        shape)
        with span("kernel"):
            velocity = boris_kick(state.velocity, eb[:, :3], eb[:, 3:],
                                  qm_half_dt, config.relativistic, config.c)
            velocity = torch.where(state.valid[:, None], velocity, 0.0)
            coord_v = _coord_velocity(config, velocity)
            x0 = state.position
            # unwrapped for the deposit
            x1 = x0 + config.dt * coord_v[:, :ndim] / dxv
            charge = torch.where(state.valid, config.charge, 0.0).to(
                torch.float32)
            if ndim == 2:
                j, _, spill_mask = esirkepov_sorted_2d(
                    x0, x1, coord_v[:, 2], charge, state.tile_id, config.dt,
                    shape, config.cell_size, self.tiling)
            else:
                j, _, spill_mask = esirkepov_sorted_3d(
                    x0, x1, charge, state.tile_id, config.dt, shape,
                    config.cell_size, self.tiling)
        with span("patch"):
            spill, idx = patch_rows(spill_mask, self._capacities())
            if idx.numel():
                # exact patch for up to spill_capacity margin out-drifters
                # (charge conservation holds while spill stays under
                # capacity)
                j = j + _deposit(config, x0[idx], x1[idx], coord_v[idx],
                                 charge[idx])
        with span("kernel"):
            x1 = torch.remainder(x1, grid_f)
        # relocation carries each patched row's own (exact) values
        with span("patch"):
            x1_k = x1[idx] if idx.numel() else None
            vel_k = velocity[idx] if idx.numel() else None
            unspilled = ~spill_mask
        x1, velocity, extra = self._relocated(state, x1, velocity, idx, x1_k,
                                              vel_k, unspilled)
        self._finish(state, x1, velocity, j, spill, **extra)

    def energies(self) -> dict[str, float]:
        # fillers carry zero velocity, so they add nothing to either form
        cfg = self.config
        fe = float(_field_energy(cfg, self.state.e, self.state.b))
        v = torch.where(self.state.valid[:, None], self.state.velocity, 0.0)
        ke = float(kinetic_energy(cfg, self.state._replace(velocity=v)))
        return {"field": fe, "kinetic": ke, "total": fe + ke}


def weibel(n_particles: int = 500_000, n_cells: int = 128, v0: float = 0.2,
           length: float = 32.0, noise: float = 1e-3, seed: int = 0,
           sorted_layout: bool = False, device=None
           ) -> "ElectromagneticPIC | SortedElectromagneticPIC":
    """2D Weibel (filamentation) instability setup: two cold
    counter-streaming (out-of-plane) electron beams, omega_p = 1 / c = 1
    units; B-field energy grows at gamma ~ v0 * omega_p.  The standard EM
    PIC validation scenario."""
    d = length / n_cells
    vol = length * length
    config = EMConfig(grid_shape=(n_cells, n_cells), cell_size=(d, d),
                      dt=0.4 * d, charge=-vol / n_particles,
                      mass=vol / n_particles, field_gather="centered")
    rng = np.random.default_rng(seed)
    pos = rng.random((n_particles, 2)) * n_cells
    vel = np.zeros((n_particles, 3), np.float32)
    vel[: n_particles // 2, 2] = v0
    vel[n_particles // 2:, 2] = -v0
    vel[:, :2] = noise * rng.standard_normal((n_particles, 2))
    cls = SortedElectromagneticPIC if sorted_layout else ElectromagneticPIC
    return cls(config, pos, vel, device=device)
