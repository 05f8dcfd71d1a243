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
import inspect
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.fused_pic import fused_es2d_substep
from ..ops.fused_pic3d import fused_es3d_substep
from ..ops.interp import cic_deposit_packed, cic_gather_packed, spill_rows
from ..ops.precision import resolve_precision
from ..ops.repair import drain_check, init_free_list, repair_relocate
from ..ops.solvers import gradient_periodic, poisson_fft
from ..ops.sorted_deposit import (Tiling2D, Tiling3D, build_padded_layout,
                                  deposit_sorted_2d, deposit_sorted_3d,
                                  gather_sorted_2d, gather_sorted_3d)
from ..utils.profiling import count, span


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


class SortedElectrostaticPIC:
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

    While a ``torch.profiler`` records, ``step`` opens the spans of
    ``utils/profiling.span`` (``fusion_sim.step`` around the call; leaf
    phases ``solve``, ``kernel``, ``patch``, ``repair``, ``resort`` and
    ``drain_check``, which hold every operation a step launches, with
    ``host_read`` inside ``patch`` around the step's read of the spill
    count) and counts ``rows_patched``, the rows of a step that took the
    exact patch.
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
        n = np.asarray(position).shape[0]
        if n % self.tiling.block:
            raise ValueError(f"particle count must be a multiple of "
                             f"{self.tiling.block}")
        self.n_real = n
        ndim = config.n_dim
        pos = torch.as_tensor(
            np.asarray(position, np.float32).reshape(n, ndim),
            device=self.device)
        vel = torch.as_tensor(
            np.asarray(velocity, np.float32).reshape(n, ndim),
            device=self.device)
        tid, pos_p, vel_p, valid_p, _ = build_padded_layout(
            pos, config.grid_shape, self.tiling, vel, reserve=repair,
            spread=repair, derive_valid=True, cell_order=ndim == 3)
        self.state = SortedESState(
            position=pos_p, velocity=vel_p, tile_id=tid, valid=valid_p,
            step=0, spill=0, spill_dropped=0)
        self._finish_state()

    def _finish_state(self) -> None:
        """The carried rho (pallas) and the repair stacks, where missing."""
        if self.backend == "pallas" and self.state.rho is None:
            self.state = self.state._replace(rho=self._initial_rho())
        if self.repair:
            if self.state.unplaced is None:
                self.state = self.state._replace(unplaced=torch.zeros(
                    (), dtype=torch.int64, device=self.device))
            if self.state.free_idx is None:
                self._rebuild_free_list()

    @classmethod
    def from_state(cls, config: ESConfig, blob: dict, tiling=None,
                   **kwargs) -> "SortedElectrostaticPIC":
        """A model on a given sorted state (``sorted_state_from_numpy``
        form) — no initial sort, so it starts from exactly that layout.
        Keyword arguments as the constructor's."""
        self = cls.__new__(cls)
        bound = inspect.signature(cls.__init__).bind(
            self, config, None, None, tiling=tiling, **kwargs)
        bound.apply_defaults()
        kw = dict(bound.arguments)
        for name in ("self", "position", "velocity"):
            del kw[name]
        self._configure(**kw)
        self.state = sorted_state_from_numpy(blob, self.device)
        self.n_real = int(self.state.valid.sum())
        self._finish_state()
        return self

    def _configure(self, config, tiling, resort_every, check_spill,
                   spill_fallback, spill_capacity, spill_tiers, backend,
                   repair, repair_free_slots, repair_eager, eager_capacity,
                   pallas_precision, device):
        if config.n_dim not in (2, 3):
            raise ValueError("sorted layout variant is 2D or 3D")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"backend {backend!r} (xla|pallas)")
        self.backend = backend
        self.spill_fallback = spill_fallback
        self.spill_capacity = int(spill_capacity)
        # spill_tiers: ascending patch capacities below spill_capacity; each
        # step compacts at the smallest one that covers its spill count.  A
        # pure performance knob: the same rows are patched either way.
        if spill_tiers is not None:
            ts = tuple(int(t) for t in spill_tiers)
            if list(ts) != sorted(set(ts)) or any(t <= 0 for t in ts) \
                    or (ts and ts[-1] >= self.spill_capacity):
                raise ValueError(
                    f"spill_tiers {spill_tiers!r} must be strictly "
                    f"ascending positives below spill_capacity "
                    f"{self.spill_capacity}")
            if repair and ts:
                raise ValueError("spill_tiers is incompatible with "
                                 "repair=True (the relocation chain is "
                                 "equilibrium-capacity-sized every step)")
            self.spill_tiers = ts
        else:
            self.spill_tiers = ()
        if repair and not spill_fallback:
            raise ValueError("repair=True requires spill_fallback=True")
        self.repair = repair
        self.repair_free_slots = int(repair_free_slots)
        self.repair_eager = int(repair_eager)
        self.eager_capacity = (int(spill_capacity) if eager_capacity is None
                               else int(eager_capacity))
        if repair_eager and self.eager_capacity <= 0:
            raise ValueError(f"eager_capacity={eager_capacity} must be > 0")
        if pallas_precision not in (None, "highest", "exact_bf16",
                                    "exact_bf16_pack", "exact_bf16_pack2",
                                    "default"):
            raise ValueError(f"pallas_precision {pallas_precision!r}")
        if pallas_precision == "exact_bf16_pack2" and config.n_dim != 2:
            raise ValueError("exact_bf16_pack2 is 2D-only")
        self.tiling = tiling or (Tiling2D() if config.n_dim == 2
                                 else Tiling3D())
        if repair_eager:
            if not repair:
                raise ValueError("repair_eager requires repair=True")
            if not 0 < repair_eager <= self.tiling.margin:
                raise ValueError(
                    f"repair_eager={repair_eager} must be in "
                    f"1..margin ({self.tiling.margin})")
        self.pallas_precision = pallas_precision
        resolve_precision(pallas_precision, self.tiling.dtype)
        self.config = config
        self.resort_every = resort_every
        self.check_spill = check_spill
        self.device = resolve_device(device)
        self._n_tiles = math.prod(self.tiling.n_tiles(config.grid_shape))
        self._since_sort = 0
        self._spill_seen = 0
        self._dropped_seen = 0
        self._unplaced_seen = 0
        self._need_resort = False

    def _rebuild_free_list(self) -> None:
        fidx, fcnt = init_free_list(self.state.tile_id, self.state.valid,
                                    self._n_tiles, self.tiling.block,
                                    self.repair_free_slots)
        self.state = self.state._replace(free_idx=fidx, free_cnt=fcnt)

    def _check_spill(self):
        # report the delta since the previous check, not the cumulative
        # counter (one spill event must not re-warn forever)
        spilled = self.state.spill - self._spill_seen
        self._spill_seen += spilled
        dropped = self.state.spill_dropped - self._dropped_seen
        self._dropped_seen += dropped
        if spilled or dropped:
            if not self.spill_fallback:
                msg = (f"{spilled} spilled rows are APPROXIMATE "
                       f"(spill_fallback=False: deposits dropped, E gathered "
                       f"from the clamped window; charge not conserved)")
            elif dropped:
                msg = (f"{dropped} spilled rows exceeded spill_capacity="
                       f"{self.spill_capacity} and were NOT patched (their "
                       f"deposits are lost; raise spill_capacity)")
            else:
                msg = (f"{spilled} particle-deposits took the slow exact "
                       f"fallback (out-drifted the sort margin)")
            warnings.warn(
                msg + f"; reduce resort_every (now {self.resort_every}) or "
                f"raise tiling.margin (now {self.tiling.margin})",
                RuntimeWarning, stacklevel=3)

    def _weights(self) -> torch.Tensor:
        w0 = self.config.charge / self.config.cell_volume
        return torch.where(self.state.valid, w0, 0.0).to(torch.float32)

    def _grid_f(self) -> torch.Tensor:
        return torch.tensor(self.config.grid_shape, dtype=torch.float32,
                            device=self.device)

    def _initial_rho(self) -> torch.Tensor:
        """Deposit at the current (freshly sorted) positions — seeds the
        carried rho."""
        pos = torch.remainder(self.state.position, self._grid_f())
        return cic_deposit_packed(pos, self._weights(), self.config.grid_shape)

    def _patch_rows(self, spill_mask: torch.Tensor, spill: int):
        """The first min(spill, capacity) rows of ``spill_mask`` in row
        order, compacted at the smallest tier that covers ``spill``."""
        cap = next((c for c in self.spill_tiers if spill <= c),
                   self.spill_capacity)
        return spill_rows(spill_mask, spill, cap,
                          spill_mask.shape[0])[0][:min(spill, cap)]

    def _repair(self, state, pos, vel, idx, pos_k, vel_k, in_win):
        """``ops/repair.repair_relocate`` with this model's settings;
        returns ``(pos, vel, state updates)``."""
        with span("repair"):
            pos, vel, _, extra = repair_relocate(
                state, pos, vel, idx, None, pos_k, vel_k,
                self.config.grid_shape, self.tiling, self._n_tiles,
                self.config.n_dim, in_win=in_win,
                eager_keep=self.repair_eager, eager_cap=self.eager_capacity)
        return pos, vel, extra

    def _advance(self, state, pos, vel, spill, **extra) -> None:
        dropped = max(spill - self.spill_capacity, 0) if self.spill_fallback \
            else spill
        count("rows_patched", spill - dropped)
        self.state = state._replace(
            position=pos, velocity=vel, step=state.step + 1,
            spill=state.spill + spill,
            spill_dropped=state.spill_dropped + dropped, **extra)

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
            spill_mask = (~in_win) & state.valid
            # the one host read of the step: it picks the patch tier
            with span("host_read"):
                spill = int(spill_mask.sum())
            idx = pos_k = vel_k = None
            if self.spill_fallback and spill:
                # exact patch of the rows that left their window; rows
                # beyond spill_capacity stay frozen and count as dropped
                idx = self._patch_rows(spill_mask, spill)
                grid_f = self._grid_f()
                dx = torch.tensor(config.cell_size, dtype=torch.float32,
                                  device=self.device)
                pos_k = torch.remainder(state.position[idx], grid_f)
                e_k = cic_gather_packed(e_grid, pos_k, shape)
                vel_k = state.velocity[idx] + qm_dt * e_k
                pos_k = torch.remainder(pos_k + config.dt * vel_k / dx,
                                        grid_f)
                rho_new = rho_new + cic_deposit_packed(pos_k, w[idx], shape)
            if not self.repair and idx is not None:
                pos[idx] = pos_k
                vel[idx] = vel_k
        extra = {}
        if self.repair:
            # patched rows carry their exact values to their new tile;
            # band rows (eager) carry their own kernel outputs
            pos, vel, extra = self._repair(state, pos, vel, idx, pos_k, vel_k,
                                           in_win)
        self._advance(state, pos, vel, spill, rho=rho_new, **extra)

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
            dx = torch.tensor(config.cell_size, dtype=torch.float32,
                              device=self.device)
            qm_dt = config.charge / config.mass * config.dt
            w = self._weights()
            rho, spill_t, spill_mask = deposit(state.position, w,
                                               state.tile_id, shape,
                                               self.tiling)
        with span("patch"):
            with span("host_read"):
                spill = int(spill_t)    # the one host read of the step
            idx = None
            if self.spill_fallback and spill:
                idx = self._patch_rows(spill_mask, spill)
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
        if idx is not None:
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
                if idx is not None:
                    pos_k, vel_k = position[idx], velocity[idx]
                unspilled = ~spill_mask
            position, velocity, extra = self._repair(
                state, position, velocity, idx, pos_k, vel_k, unspilled)
        self._advance(state, position, velocity, spill, **extra)

    def _resort(self) -> None:
        """Rebuild the layout (one sort); fillers and invalid rows sink to
        the trailing dead region, which the truncation drops."""
        with span("resort"):
            s = self.state
            n_state = s.position.shape[0]
            tid, pos_p, vel_p, valid_p, _ = build_padded_layout(
                s.position, self.config.grid_shape, self.tiling, s.velocity,
                valid=s.valid, reserve=self.repair, spread=self.repair,
                derive_valid=True, cell_order=self.config.n_dim == 3)
            self.state = s._replace(
                position=pos_p[:n_state], velocity=vel_p[:n_state],
                tile_id=tid[:n_state], valid=valid_p[:n_state])
            if self.repair:
                self._rebuild_free_list()

    def step(self, n: int = 1) -> None:
        """Advance ``n`` steps with the reference's resort cadence: without
        repair, a call spanning a whole window runs ``resort_every`` steps
        and THEN resorts (the counter stays 0); partial chunks count toward
        the next window, whose resort runs at the start of a later call.
        With repair the resort runs at the start of a window, and a call
        ends with the drain check."""
        with span("step"):
            step_once = (self._step_pallas if self.backend == "pallas"
                         else self._step_xla)
            done = 0
            while done < n:
                if self._since_sort >= self.resort_every or self._need_resort:
                    self._resort()
                    self._since_sort = 0
                    self._need_resort = False
                if (not self.repair and self._since_sort == 0
                        and n - done >= self.resort_every
                        and self.resort_every <= 128):
                    for _ in range(self.resort_every):
                        step_once()
                    self._resort()
                    done += self.resort_every
                    continue
                k = min(n - done, self.resort_every - self._since_sort)
                for _ in range(k):
                    step_once()
                self._since_sort += k
                done += k
            if self.repair:
                # a small unplaced trickle is normal (a row whose target tile
                # is full keeps its exact patch and retries); a large delta
                # means the stacks drained: resort at the next call.  Scaled to
                # the buffer that carries the flux (eager configurations ride
                # eager_capacity)
                cap = max(self.spill_capacity,
                          self.eager_capacity if self.repair_eager else 0)
                self._need_resort, self._unplaced_seen, _ = drain_check(
                    self.state, self._unplaced_seen, 0, cap, self.n_real, n)
            if self.check_spill:
                self._check_spill()

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
