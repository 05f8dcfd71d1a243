"""Electrostatic particle-in-cell model (periodic, 1D/2D/3D; sorted 2D/3D).

Port of ``fusion_sim_tpu/models/electrostatic.py``.  The self-consistent
loop, with leapfrog time-staggering (velocities at half-integer steps) and
a static neutralizing background:

    rho  = CIC-deposit(q, x)              (ops/interp.cic_deposit_packed)
    phi  = FFT Poisson solve              (ops/solvers.poisson_fft)
    E    = -grad(phi)                     (ops/solvers.gradient_periodic)
    v   += (q/m) E(x) dt                  (ops/interp.cic_gather_packed)
    x   += v dt                           (periodic wrap)

``SortedElectrostaticPIC(backend='pallas')`` is the main path: particles
live in the padded tile-sorted layout, and one fused kernel per step does
gather + kick + drift + deposit (ops/fused_pic.py in 2D, ops/fused_pic3d.py
in 3D) between FFT solves.  ``backend='xla'`` runs the same step in plain
PyTorch (windowed deposit and gather of ops/sorted_deposit.py), and
``repair=True`` relocates spilled rows into their new tile every step
(ops/repair.py) instead of waiting for the resort.

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
from ..ops.fused_pic import fused_es2d_substep
from ..ops.fused_pic3d import fused_es3d_substep
from ..ops.interp import cic_deposit_packed, cic_gather_packed, patch_rows
from ..ops.precision import resolve_precision
from ..ops.solvers import gradient_periodic, poisson_fft
from ..ops.sorted_deposit import (deposit_sorted_2d, deposit_sorted_3d,
                                  gather_sorted_2d, gather_sorted_3d)
from ..utils.profiling import span
from ._sorted_shell import SortedShell


class ESState(NamedTuple):
    """Particles at step n: position (N, d) in grid units, velocity (N, d)
    in physical units."""

    position: torch.Tensor
    velocity: torch.Tensor
    step: int


@dataclasses.dataclass(frozen=True)
class ESConfig:
    grid_shape: tuple[int, ...]     # cells per axis (periodic)
    cell_size: tuple[float, ...]    # dx per axis
    dt: float
    charge: float                   # per macro-particle
    mass: float                     # per macro-particle
    eps0: float = 1.0
    neutralizing_background: bool = True
    # the reference's dense-DFT matmul strategy; the port solves with
    # torch.fft in f32 whatever it says (ops/precision.py)
    solver_precision: str = "highest"

    @property
    def n_dim(self) -> int:
        return len(self.grid_shape)

    @property
    def lengths(self) -> tuple[float, ...]:
        return tuple(n * d for n, d in zip(self.grid_shape, self.cell_size))

    @property
    def cell_volume(self) -> float:
        return math.prod(self.cell_size)


def charge_density(config: ESConfig, position: torch.Tensor) -> torch.Tensor:
    """CIC charge density, optionally neutralized to zero mean (follows
    ``position``'s dtype)."""
    weights = torch.full((position.shape[0],),
                         config.charge / config.cell_volume,
                         dtype=position.dtype, device=position.device)
    rho = cic_deposit_packed(position, weights, config.grid_shape)
    if config.neutralizing_background:
        rho = rho - rho.mean()
    return rho


def solve_fields(config: ESConfig, rho: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """phi and E = -grad(phi) on the grid; E has a trailing axis of size d.

    Always the FFT solve (cuFFT on the card).  The reference routes 2D
    grids up to 2048^2 through its dense-DFT matmul form only because the
    TPU's FFT is emulated; the two agree to ~1e-5 relative."""
    resolve_precision(config.solver_precision)
    phi = poisson_fft(rho, config.cell_size, eps0=config.eps0)
    grads = gradient_periodic(phi, config.cell_size)
    return phi, torch.stack([-g for g in grads], dim=-1)


def make_step_fn(config: ESConfig):
    """One leapfrog PIC step: deposit + solve + gather + push."""
    shape = config.grid_shape
    qm_dt = config.charge / config.mass * config.dt

    def step(state: ESState) -> ESState:
        dx = torch.tensor(config.cell_size, dtype=state.position.dtype,
                          device=state.position.device)
        grid_f = torch.tensor(shape, dtype=state.position.dtype,
                              device=state.position.device)
        rho = charge_density(config, state.position)
        _, e_grid = solve_fields(config, rho)
        e_at_p = cic_gather_packed(e_grid, state.position, shape)
        velocity = state.velocity + qm_dt * e_at_p
        position = state.position + (config.dt * velocity) / dx
        position = torch.remainder(position, grid_f)
        return ESState(position, velocity, state.step + 1)

    return step


def energies(config: ESConfig, state: ESState) -> dict[str, torch.Tensor]:
    """Kinetic, field, and total energy."""
    ke = 0.5 * config.mass * torch.sum(state.velocity ** 2)
    _, e_grid = solve_fields(config, charge_density(config, state.position))
    fe = 0.5 * config.eps0 * torch.sum(e_grid ** 2) * config.cell_volume
    return {"kinetic": ke, "field": fe, "total": ke + fe}


def momentum(config: ESConfig, state: ESState) -> torch.Tensor:
    return config.mass * torch.sum(state.velocity, dim=0)


def es_state_from_numpy(blob: dict, device=None) -> ESState:
    """An ``ESState`` from the reference's state as numpy arrays
    (``{k: np.asarray(v) for k, v in jax_model.state._asdict().items()}``)."""
    dev = resolve_device(device)
    return ESState(
        position=torch.tensor(np.asarray(blob["position"], np.float32),
                              device=dev),
        velocity=torch.tensor(np.asarray(blob["velocity"], np.float32),
                              device=dev),
        step=int(blob.get("step", 0)))


class ElectrostaticPIC:
    """Stateful shell over the functional core."""

    def __init__(self, config: ESConfig, position, velocity, device=None):
        self.config = config
        n = np.asarray(position).shape[0]
        self.state = es_state_from_numpy(
            {"position": np.asarray(position).reshape(n, config.n_dim),
             "velocity": np.asarray(velocity).reshape(n, config.n_dim)},
            device)
        self._step = make_step_fn(config)

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self.state = self._step(self.state)

    def energies(self) -> dict[str, float]:
        return {k: float(v) for k, v in energies(self.config,
                                                 self.state).items()}

    def fields(self) -> tuple[torch.Tensor, torch.Tensor]:
        return solve_fields(self.config,
                            charge_density(self.config, self.state.position))

    def get_state(self) -> dict[str, np.ndarray]:
        return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in self.state._asdict().items()}

    def set_state(self, blob: dict[str, np.ndarray]) -> None:
        self.state = es_state_from_numpy(blob, self.state.position.device)


# ---------------------------------------------------------------------------
# Sorted-layout variant (2D and 3D): the fused-kernel main path
# ---------------------------------------------------------------------------

class SortedESState(NamedTuple):
    """Padded tile-sorted particle layout (fillers: valid=False, weight 0)."""

    position: torch.Tensor   # (Npad, d) grid units, d = 2 or 3
    velocity: torch.Tensor   # (Npad, d)
    tile_id: torch.Tensor    # (Npad,) int32, tile at last resort
    valid: torch.Tensor      # (Npad,) bool
    step: int
    spill: int               # cumulative out-of-margin rows (patched)
    spill_dropped: int       # cumulative rows past spill_capacity
    rho: torch.Tensor | None = None  # pallas: charge at current positions
    # incremental layout repair (repair=True) only:
    free_idx: torch.Tensor | None = None  # (n_tiles, F) dead-slot stacks
    free_cnt: torch.Tensor | None = None  # (n_tiles,)
    unplaced: torch.Tensor | None = None  # cumulative spills left in place
                                          # (no free slot), on the device


def sorted_state_from_numpy(blob: dict, device=None) -> SortedESState:
    """A ``SortedESState`` from the reference's sorted state as numpy
    arrays (``{k: np.asarray(v) for k, v in jax_model.state._asdict()
    .items() if v is not None}``): both packages then share one layout."""
    dev = resolve_device(device)

    def t(key, dtype):
        if blob.get(key) is None:
            return None
        return torch.tensor(np.asarray(blob[key], dtype), device=dev)

    return SortedESState(
        position=t("position", np.float32), velocity=t("velocity", np.float32),
        tile_id=t("tile_id", np.int32), valid=t("valid", np.bool_),
        step=int(blob.get("step", 0)), spill=int(blob.get("spill", 0)),
        spill_dropped=int(blob.get("spill_dropped", 0)),
        rho=t("rho", np.float32), free_idx=t("free_idx", np.int64),
        free_cnt=t("free_cnt", np.int64), unplaced=t("unplaced", np.int64))


class SortedElectrostaticPIC(SortedShell):
    """ES PIC (2D or 3D) on the tile-sorted layout with the fused particle
    kernel.

    Physics identical to ``ElectrostaticPIC`` (same CIC/FFT/leapfrog).
    Particles live in the padded tile-sorted layout of
    ops/sorted_deposit.build_padded_layout; the shell resorts every
    ``resort_every`` steps (size the cadence so drift stays under
    ``tiling.margin`` cells).  Rows that out-drift their window anyway are
    patched exactly, up to ``spill_capacity`` a step.

    Constructor arguments, validation and defaults are the reference's;
    3D takes a ``Tiling3D``.  ``backend='pallas'`` runs the fused kernel
    (ops/fused_pic.py in 2D, ops/fused_pic3d.py in 3D), ``backend='xla'``
    the plain windowed deposit and gather.  In 3D the layout orders each
    tile's rows by cell (``build_padded_layout(cell_order=True)``), at
    build and at every resort, so that kernel B5 sums a warp's rows of
    one cell before it adds them to its window.

    ``repair=True`` relocates the spilled rows every step into dead slots
    of their new tile (ops/repair.py; the layout is built with ``reserve``
    and ``spread``); the full resort then runs every ``resort_every`` steps
    or when the free stacks drain: a ``step()`` call reads the device's
    ``unplaced`` count once and schedules a resort for the next call when
    it grew by more than max(64, capacity // 8) a step.  ``repair_eager=k``
    (1..margin) also relocates rows within k cells of leaving their
    window, carrying their own exact values, up to ``eager_capacity`` rows
    a step; ``repair_free_slots`` sizes each tile's stack.

    ``step`` opens the spans of ``utils/profiling.span``, a profiler's
    annotations while one records, else the host clock's phases
    (``fusion_sim.step`` around the call; leaf phases ``solve``, ``kernel``,
    ``patch``, ``repair``, ``resort`` and ``drain_check``, which hold every
    operation a step launches, with ``host_read`` inside ``patch`` around
    the step's read of the spill count), and while a profiler records counts
    ``rows_patched``, the rows of a step that took the exact patch.
    """

    def __init__(self, config: ESConfig, position, velocity,
                 tiling=None, resort_every: int = 6,
                 check_spill: bool = True, spill_fallback: bool = True,
                 spill_capacity: int = 16384,
                 spill_tiers: tuple[int, ...] | None = None,
                 backend: str = "xla", repair: bool = False,
                 repair_free_slots: int = 256,
                 repair_eager: int = 0, eager_capacity: int | None = None,
                 pallas_precision: str | None = None, device=None):
        self._configure(config, tiling, resort_every, check_spill,
                        spill_fallback, spill_capacity, spill_tiers, backend,
                        repair, repair_free_slots, repair_eager,
                        eager_capacity, pallas_precision, device)
        self.state = SortedESState(
            **self._initial_layout(position, velocity, config.n_dim))
        self._finish_state()

    _state_from_numpy = staticmethod(sorted_state_from_numpy)

    def _configure(self, config, tiling, resort_every, check_spill,
                   spill_fallback, spill_capacity, spill_tiers, backend,
                   repair, repair_free_slots, repair_eager, eager_capacity,
                   pallas_precision, device):
        if config.n_dim not in (2, 3):
            raise ValueError("sorted layout variant is 2D or 3D")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend {backend!r} (xla|pallas)")
        self.backend = backend
        self._configure_layout(config, tiling, resort_every, check_spill,
                               spill_fallback, spill_capacity, spill_tiers,
                               repair, repair_free_slots, repair_eager,
                               eager_capacity, pallas_precision, device)
        self._cell_order = config.n_dim == 3
        self._step_once = (self._step_pallas if backend == "pallas"
                           else self._step_xla)

    def _finish_state(self) -> None:
        """The carried rho (pallas), then the repair state, where missing."""
        if self.backend == "pallas" and self.state.rho is None:
            self.state = self.state._replace(rho=self._initial_rho())
        super()._finish_state()

    def _weights(self) -> torch.Tensor:
        w0 = self.config.charge / self.config.cell_volume
        return torch.where(self.state.valid, w0, 0.0).to(torch.float32)

    def _grid_f(self) -> torch.Tensor:
        return device_const(self.config.grid_shape, self.device)

    def _initial_rho(self) -> torch.Tensor:
        """Deposit at the current (freshly sorted) positions — seeds the
        carried rho."""
        pos = torch.remainder(self.state.position, self._grid_f())
        return cic_deposit_packed(pos, self._weights(), self.config.grid_shape)

    def _step_pallas(self) -> None:
        """Solve E from the carried rho, then ONE fused kernel does gather +
        kick + drift + deposit; spilled rows are re-pushed exactly."""
        config, state = self.config, self.state
        shape = config.grid_shape
        with span("solve"):
            rho = state.rho
            if config.neutralizing_background:
                rho = rho - torch.sum(rho) / math.prod(shape)
            _, e_grid = solve_fields(config, rho)
        with span("kernel"):
            w = self._weights()
            qm_dt = float(config.charge / config.mass * config.dt)
            c_ax = (float(config.dt / d) for d in config.cell_size)
            substep = (fused_es2d_substep if config.n_dim == 2
                       else fused_es3d_substep)
            pos, vel, rho_new, in_win = substep(
                e_grid, state.position, state.velocity, w, state.tile_id,
                shape, self.tiling, qm_dt, *c_ax,
                precision=self.pallas_precision or "highest")
        with span("patch"):
            # the one host read of the step: it picks the patch tier; the
            # rows that left their window are patched exactly, and rows
            # beyond spill_capacity stay frozen and count as dropped
            spill, idx = patch_rows((~in_win) & state.valid,
                                    self._capacities())
            pos_k = vel_k = None
            if idx.numel():
                grid_f = self._grid_f()
                dx = device_const(config.cell_size, self.device)
                pos_k = torch.remainder(state.position[idx], grid_f)
                e_k = cic_gather_packed(e_grid, pos_k, shape)
                vel_k = state.velocity[idx] + qm_dt * e_k
                pos_k = torch.remainder(pos_k + config.dt * vel_k / dx,
                                        grid_f)
                rho_new = rho_new + cic_deposit_packed(pos_k, w[idx], shape)
                if not self.repair:
                    pos[idx] = pos_k
                    vel[idx] = vel_k
        # patched rows carry their exact values to their new tile; band
        # rows (eager) carry their own kernel outputs
        pos, vel, extra = self._relocated(state, pos, vel, idx, pos_k, vel_k,
                                          in_win)
        self.state = state._replace(position=pos, velocity=vel, rho=rho_new,
                                    **self._advanced(state, spill), **extra)

    def _step_xla(self) -> None:
        """The same step in plain PyTorch: windowed deposit, exact patch of
        the out-of-window rows, FFT solve, windowed gather (patched), kick
        and drift (the reference's ``_make_step``)."""
        config, state = self.config, self.state
        shape = config.grid_shape
        two_d = config.n_dim == 2
        deposit = deposit_sorted_2d if two_d else deposit_sorted_3d
        gather = gather_sorted_2d if two_d else gather_sorted_3d
        with span("kernel"):
            grid_f = self._grid_f()
            dx = device_const(config.cell_size, self.device)
            qm_dt = config.charge / config.mass * config.dt
            w = self._weights()
            rho, spill_t, spill_mask = deposit(state.position, w,
                                               state.tile_id, shape,
                                               self.tiling)
        with span("patch"):
            # the one host read of the step
            spill, idx = patch_rows(spill_mask, self._capacities(), spill_t)
            if idx.numel():
                rho = rho + cic_deposit_packed(
                    torch.remainder(state.position[idx], grid_f), w[idx],
                    shape)
        with span("solve"):
            if config.neutralizing_background:
                rho = rho - torch.sum(rho) / math.prod(shape)
            _, e_grid = solve_fields(config, rho)
        # gather and deposit share the window criterion at the same
        # positions, so the deposit's patch rows patch both
        with span("kernel"):
            e_at_p, _ = gather(e_grid, state.position, state.tile_id, shape,
                               self.tiling)
        if idx.numel():
            with span("patch"):
                e_at_p[idx] = cic_gather_packed(
                    e_grid, torch.remainder(state.position[idx], grid_f),
                    shape)
        with span("kernel"):
            velocity = state.velocity + qm_dt * e_at_p
            velocity = torch.where(state.valid[:, None], velocity, 0.0)
            position = state.position + (config.dt * velocity) / dx
            position = torch.remainder(position, grid_f)
        extra = {}
        if self.repair:
            with span("patch"):
                pos_k = vel_k = None
                if idx.numel():
                    pos_k, vel_k = position[idx], velocity[idx]
                unspilled = ~spill_mask
            position, velocity, extra = self._relocated(
                state, position, velocity, idx, pos_k, vel_k, unspilled)
        self.state = state._replace(position=position, velocity=velocity,
                                    **self._advanced(state, spill), **extra)

    def energies(self) -> dict[str, float]:
        cfg = self.config
        valid = self.state.valid
        v = self.state.velocity
        ke = 0.5 * cfg.mass * float(torch.sum(
            torch.where(valid[:, None], v, 0.0) ** 2))
        w = self._weights()
        deposit = deposit_sorted_2d if cfg.n_dim == 2 else deposit_sorted_3d
        rho, spill, spill_mask = deposit(
            self.state.position, w, self.state.tile_id, cfg.grid_shape,
            self.tiling)
        if self.spill_fallback and int(spill):
            # the step's exact fallback, so the diagnostic sees its rho
            rho = rho + cic_deposit_packed(
                torch.remainder(self.state.position, self._grid_f()),
                torch.where(spill_mask, w, 0.0), cfg.grid_shape)
        if cfg.neutralizing_background:
            rho = rho - rho.mean()
        _, e_grid = solve_fields(cfg, rho)
        fe = 0.5 * cfg.eps0 * float(torch.sum(e_grid ** 2)) * cfg.cell_volume
        return {"kinetic": ke, "field": fe, "total": ke + fe}


# ---------------------------------------------------------------------------
# Canonical validation scenarios
# ---------------------------------------------------------------------------

def two_stream(n_particles: int = 100_000, n_cells: int = 512,
               v0: float = 0.2, perturbation: float = 1e-3, mode: int = 1,
               length: float | None = None, dt: float = 0.1, seed: int = 0,
               device=None) -> ElectrostaticPIC:
    """1D cold two-stream instability in normalized units (omega_p = 1 for
    the total electron population).  Quiet start: particles evenly spaced,
    split into +/- v0 beams, with a sinusoidal position perturbation."""
    if length is None:
        # put the seeded mode near peak growth
        length = 2 * np.pi * mode * v0 / 0.6
    dx = length / n_cells
    q_over_m = -1.0
    n_density = n_particles / length
    charge = -1.0 / n_density
    mass = charge * (1.0 / q_over_m)
    config = ESConfig(grid_shape=(n_cells,), cell_size=(dx,), dt=dt,
                      charge=charge, mass=mass)
    half = n_particles // 2
    x0 = (np.arange(half) + 0.5) / half * length
    x = np.concatenate([x0, x0])
    x = x + perturbation * length * np.sin(2 * np.pi * mode * x / length)
    v = np.concatenate([np.full(half, v0), np.full(half, -v0)])
    pos = (x / dx) % n_cells
    return ElectrostaticPIC(config, pos[:, None], v[:, None], device=device)


def landau(n_particles: int = 200_000, n_cells: int = 128,
           k_lambda_d: float = 0.5, v_thermal: float = 1.0,
           perturbation: float = 0.05, dt: float = 0.1, seed: int = 0,
           device=None) -> ElectrostaticPIC:
    """1D Landau damping setup: Maxwellian plasma with a density
    perturbation at k*lambda_D = ``k_lambda_d`` (omega_p = 1,
    lambda_D = v_thermal)."""
    k = k_lambda_d / v_thermal
    length = 2 * np.pi / k
    dx = length / n_cells
    n_density = n_particles / length
    charge = -1.0 / n_density
    mass = -charge
    config = ESConfig(grid_shape=(n_cells,), cell_size=(dx,), dt=dt,
                      charge=charge, mass=mass)
    rng = np.random.default_rng(seed)
    # quiet start in x with the density perturbation via inverse CDF
    u = (np.arange(n_particles) + 0.5) / n_particles
    x = u * length
    for _ in range(6):  # Newton iterations for x + (a/k) sin(kx) = u*L
        x = x - (x + perturbation / k * np.sin(k * x) - u * length) / (
            1 + perturbation * np.cos(k * x))
    v = rng.normal(0.0, v_thermal, n_particles)
    pos = (x / dx) % n_cells
    return ElectrostaticPIC(config, pos[:, None], v[:, None], device=device)
