"""CylindricalParticlePusher — the test-particle model (port of
``fusion_sim_tpu/models/pusher.py``).

A charged-particle pusher in a cylindrically symmetric magnetized plasma
with static imposed E/B fields, Monte-Carlo sink/respawn, grid moment
deposition and density/|B| rendering (``makeCylindricalParticlePusher``,
empic.js:30-1529).

Units follow the reference: positions are Cartesian (x, y, z) scaled per
axis by (1/radius, 1/radius, 1/height); velocities are in units of c with
the same scaling; h = q*dt/(2m) (empic.js:44-46, 1202-1204).

The plain grid path (``make_step_fn``) is the reference's parity path: two
half-steps, each a velocity pass (coefficient gather + Boris rotation, or
thermal re-init of fresh rows) and a position pass (drift + sink/respawn).
``enable_sorted_path`` switches to the tile-sorted layout
(models/pusher_sorted.py), whose ``backend='fused'`` runs kernel B2 and
``backend='pallas'`` kernel B3; ``enable_fast_path`` switches to the
analytic gather-free path (ops/analytic.py), which recomputes B at each
particle from the field sources the set-up methods record (``_sources``).

Random numbers: the reference's ``jax.random`` key becomes a
``torch.Generator`` on the model's device (Philox on the card), which
cannot replay JAX's streams.  Step functions therefore take the substep
uniforms as an argument; the shell draws them from its generator.  Every
entry point runs on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..config import Optional as OptionalSpec, validate_object
from ..constants import SPEED_OF_LIGHT
from ..ops import fields as field_ops
from ..ops.boris import BorisCoefficients, precompute_rotation, push_velocity
from ..ops.deposit import deposit_moments, ema_moments, normalize_moments
from ..ops.push import push_position
from ..ops.rng import substep_uniforms
from ..ops.sampling import INV_CDF_SIZE, build_inverse_cdf_table
from ..utils.profiling import span
from ..utils.render import render_bmag, render_density_overlay
from ._sorted_shell import (check_tiers, run_cadence, with_free_list,
                            with_repair_state)

SPEC_SCHEMA = {
    # the validated spec of empic.js:31-41
    "radius": "number",   # meters
    "height": "number",   # meters
    "nr": "number",
    "nz": "number",
    "dt": "number",       # seconds
    "nparticles": "number",  # particle count is nparticles^2 (empic.js:107)
    "particle_mass": "number",    # kg
    "particle_charge": "number",  # C
    # beyond the reference spec: coefficient sampling mode
    "interp": OptionalSpec("string"),  # 'nearest' (parity) | 'bilinear'
}

LOOP_FIELD_MODES = ("table", "exact")


class PusherState(NamedTuple):
    """Per-step particle state (the reference's PRNG key is the shell's
    generator here)."""

    position: torch.Tensor     # (N, 3) normalized Cartesian
    velocity: torch.Tensor     # (N, 3) normalized (units of c, per axis)
    alive: torch.Tensor        # (N,) the position.w flag (empic.js:719)
    moments_avg: torch.Tensor  # (nr, nz, 4) EMA of normalized moments


class FieldState(NamedTuple):
    """Field configuration, changed only by the set-up methods."""

    e: torch.Tensor            # (nr, nz, 3) V/m
    b: torch.Tensor            # (nr, nz, 3) T, (B_r, B_theta, B_z)
    coeffs: BorisCoefficients
    sink_mask: torch.Tensor    # (nr, nz) 1 = keep, 0 = absorb
    inv_cdf: torch.Tensor      # (512, 512, 2) respawn sampler table


@dataclasses.dataclass(frozen=True)
class PusherSpec:
    """Static configuration."""

    radius: float
    height: float
    nr: int
    nz: int
    dt: float
    nparticles: int          # per side; the count is nparticles**2
    particle_mass: float
    particle_charge: float
    interp: str = "nearest"  # field sampling; 'nearest' is reference parity

    @property
    def n_total(self) -> int:
        return self.nparticles * self.nparticles

    @property
    def h(self) -> float:
        return self.particle_charge * self.dt / (2.0 * self.particle_mass)

    @property
    def factor_r(self) -> float:
        return 1.0 / self.radius

    @property
    def factor_z(self) -> float:
        return 1.0 / self.height

    @property
    def step_factor(self) -> float:
        return self.dt * SPEED_OF_LIGHT


def _substep(spec: PusherSpec, fields: FieldState, state: PusherState,
             rand: torch.Tensor) -> PusherState:
    """One leapfrog half-step: velocity pass, then position pass, both
    consuming this substep's uniforms (empic.js:1436-1469)."""
    velocity = push_velocity(state.position, state.velocity, state.alive,
                             rand, fields.coeffs, interp=spec.interp)
    position, alive = push_position(state.position, velocity, rand,
                                    fields.sink_mask, fields.inv_cdf,
                                    spec.step_factor)
    return state._replace(position=position, velocity=velocity, alive=alive)


def make_step_fn(spec: PusherSpec):
    """``step(fields, state, rands) -> state``: one full step, two
    half-steps (empic.js:1436-1469); ``rands`` holds the two substeps'
    (N, 4) uniforms, in order."""

    def step(fields: FieldState, state: PusherState, rands) -> PusherState:
        for rand in rands:
            state = _substep(spec, fields, state, rand)
        return state

    return step


def make_multi_step_fn(spec: PusherSpec, n_steps: int):
    """``run(fields, state, generator) -> state``: ``n_steps`` full steps,
    drawing each substep's uniforms from ``generator`` (a loop: PyTorch
    runs eagerly, so there is no scan to build)."""
    step = make_step_fn(spec)

    def run(fields: FieldState, state: PusherState,
            generator: torch.Generator) -> PusherState:
        dev = state.position.device
        for _ in range(n_steps):
            rands = [substep_uniforms(generator, spec.n_total, dev)
                     for _ in range(2)]
            state = step(fields, state, rands)
        return state

    return run


def make_density_fn(spec: PusherSpec):
    """``density(fields, state) -> (state, frame)``: deposit, normalize,
    EMA and render (empic.js:1471-1526); the frame is (nr, nz, 3) RGB."""

    def density(fields: FieldState, state: PusherState):
        moments = deposit_moments(state.position, state.velocity, spec.nr,
                                  spec.nz)
        avg = ema_moments(normalize_moments(moments), state.moments_avg)
        frame = render_density_overlay(render_bmag(fields.b), avg)
        return state._replace(moments_avg=avg), frame

    return density


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(np.asarray(value, np.float32), device=device)


def pusher_state_from_numpy(blob: dict, device=None
                            ) -> tuple[PusherState, FieldState]:
    """``(PusherState, FieldState)`` from the dict that
    ``CylindricalParticlePusher.get_state()`` returns, in either package:
    ``state.*`` and ``fields.*`` (``fields.coeffs.{r1,r2,r3,a}`` included).
    The reference's ``state.key`` is read and ignored: it cannot become a
    torch generator state (``set_state`` restores the port's own
    ``state.generator.<device type>`` instead)."""
    dev = resolve_device(device)
    state = PusherState(
        position=_f32(blob["state.position"], dev),
        velocity=_f32(blob["state.velocity"], dev),
        alive=_f32(blob["state.alive"], dev),
        moments_avg=_f32(blob["state.moments_avg"], dev))
    fields = FieldState(
        e=_f32(blob["fields.e"], dev), b=_f32(blob["fields.b"], dev),
        coeffs=BorisCoefficients(*(_f32(blob[f"fields.coeffs.{k}"], dev)
                                   for k in BorisCoefficients._fields)),
        sink_mask=_f32(blob["fields.sink_mask"], dev),
        inv_cdf=_f32(blob["fields.inv_cdf"], dev))
    return state, fields


class CylindricalParticlePusher:
    """Stateful shell with the reference's API surface
    (``makeCylindricalParticlePusher``, empic.js:30-1529): ``set``,
    ``add_current_loop``, ``add_current_z``, ``add_bz``, ``add_btheta``,
    ``precalc``, ``step``, ``density``, ``get_state``/``set_state``, the
    sorted path and the analytic fast path.  ``device`` None means the CUDA
    card."""

    def __init__(self, spec: dict[str, Any] | PusherSpec, *, seed: int = 0,
                 loop_field_mode: str = "table", device=None):
        if isinstance(spec, dict):
            validate_object(spec, SPEC_SCHEMA)
            spec = PusherSpec(
                radius=float(spec["radius"]), height=float(spec["height"]),
                nr=int(spec["nr"]), nz=int(spec["nz"]), dt=float(spec["dt"]),
                nparticles=int(spec["nparticles"]),
                particle_mass=float(spec["particle_mass"]),
                particle_charge=float(spec["particle_charge"]),
                interp=str(spec.get("interp", "nearest")))
        if loop_field_mode not in LOOP_FIELD_MODES:
            raise ValueError(f"loop_field_mode {loop_field_mode!r} "
                             f"(one of {LOOP_FIELD_MODES})")
        self.spec = spec
        self.loop_field_mode = loop_field_mode
        self.device = dev = resolve_device(device)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        nr, nz, n = spec.nr, spec.nz, spec.n_total
        # shape tables precomputed eagerly, like empic.js:333-345
        self._loop_half = self._loop_tenth = None
        if loop_field_mode == "table":
            self._loop_half, self._loop_tenth = field_ops.make_loop_tables(
                nr, nz, dev)

        f32 = torch.float32
        zeros = torch.zeros((nr, nz, 3), dtype=f32, device=dev)
        self.fields = FieldState(
            e=zeros, b=zeros,
            coeffs=precompute_rotation(zeros, zeros, spec.h, spec.factor_r,
                                       spec.factor_z),
            sink_mask=torch.ones((nr, nz), dtype=f32, device=dev),
            inv_cdf=torch.zeros((INV_CDF_SIZE, INV_CDF_SIZE, 2), dtype=f32,
                                device=dev))
        self.state = PusherState(
            position=torch.zeros((n, 3), dtype=f32, device=dev),
            velocity=torch.zeros((n, 3), dtype=f32, device=dev),
            alive=torch.ones((n,), dtype=f32, device=dev),
            moments_avg=torch.zeros((nr, nz, 4), dtype=f32, device=dev))
        self._step = make_step_fn(spec)
        self._density = make_density_fn(spec)
        self._sorted_state = None
        # field sources recorded for the analytic fast path (ops/analytic.py)
        self._sources: list[tuple] = []
        self._fast_scenario = None

    # ------------------------------------------------------------ setup
    def set(self, value: dict[str, Any]) -> None:
        """Upload state (``out.set``, empic.js:1157-1350).  Accepts any of
        ``E``/``B`` (nr, nz, 3) physical fields, ``position`` (N, 3)
        metres, ``velocity`` (N, 3) units of c, ``sink_mask`` (nr, nz),
        ``source_pdf`` (nr, nz); positions and velocities are scaled per
        axis (empic.js:1202-1231)."""
        spec, dev = self.spec, self.device
        nr, nz, n = spec.nr, spec.nz, spec.n_total
        scale = torch.tensor([spec.factor_r, spec.factor_r, spec.factor_z],
                             dtype=torch.float32, device=dev)
        if "E" in value:
            self.fields = self.fields._replace(
                e=_f32(value["E"], dev).reshape(nr, nz, 3))
            # not an analytic source: recorded so that enable_fast_path
            # refuses instead of silently dropping it
            self._sources.append(("grid_e",))
        if "B" in value:
            self.fields = self.fields._replace(
                b=_f32(value["B"], dev).reshape(nr, nz, 3))
            # replaces the recorded analytic sources on the grid: the fast
            # path refuses instead of rebuilding B from them alone
            self._sources.append(("grid_b",))
        if "position" in value:
            self.state = self.state._replace(
                position=_f32(value["position"], dev).reshape(n, 3) * scale,
                alive=torch.ones((n,), dtype=torch.float32, device=dev))
        if "velocity" in value:
            self.state = self.state._replace(
                velocity=_f32(value["velocity"], dev).reshape(n, 3) * scale)
        if "sink_mask" in value:
            self.fields = self.fields._replace(
                sink_mask=_f32(value["sink_mask"], dev).reshape(nr, nz))
        if "source_pdf" in value:
            pdf = _f32(value["source_pdf"], dev).reshape(nr, nz)
            self.fields = self.fields._replace(
                inv_cdf=build_inverse_cdf_table(pdf))

    def _add_b(self, delta: torch.Tensor) -> None:
        self.fields = self.fields._replace(b=self.fields.b + delta)

    def add_current_loop(self, r: float, z: float, current: float) -> None:
        """Accumulate a current loop's B (empic.js:1352-1363):
        ``loop_field_mode='table'`` is the reference's two-table lookup,
        ``'exact'`` the elliptic-integral closed form on physical
        coordinates."""
        spec = self.spec
        if self.loop_field_mode == "table":
            delta = field_ops.current_loop_b_table(
                self._loop_half, self._loop_tenth, r * spec.factor_r,
                z * spec.factor_z, current)
        else:
            u, v = field_ops.grid_coords(spec.nr, spec.nz, self.device)
            shape = (spec.nr, spec.nz)
            delta = field_ops.current_loop_b_exact(
                torch.broadcast_to(u * spec.radius, shape),
                torch.broadcast_to(v * spec.height, shape), r, z, current)
        self._add_b(delta)
        self._sources.append(("loop", float(r), float(z), float(current)))

    def add_current_z(self, current: float) -> None:
        """Axial line current (empic.js:1380-1389)."""
        self._add_b(field_ops.line_current_b(self.spec.nr, self.spec.nz,
                                             current, self.device))
        self._sources.append(("line", float(current)))

    def add_bz(self, bz: float) -> None:
        """Uniform B_z (empic.js:1391-1400)."""
        self._add_b(field_ops.uniform_bz(self.spec.nr, self.spec.nz, bz,
                                         self.device))
        self._sources.append(("bz", float(bz)))

    def add_btheta(self, btheta: float) -> None:
        """Uniform B_theta (empic.js:1402-1411)."""
        self._add_b(field_ops.uniform_btheta(self.spec.nr, self.spec.nz,
                                             btheta, self.device))
        self._sources.append(("btheta", float(btheta)))

    def add_spindle_cusp_plasma_field(self, coil_current: float,
                                      n_power: int = 3) -> None:
        """Spindle-cusp conductor boundary solve (empic.js:1369-1378): the
        BEM surface-current field of models/spindle.py added to B.  It is
        a grid-only source, recorded so that the fast path refuses it."""
        from .spindle import spindle_cusp_field

        spec = self.spec
        self._add_b(spindle_cusp_field(
            radius=spec.radius, height=spec.height, nr=spec.nr, nz=spec.nz,
            coil_current=coil_current, n_power=n_power, device=self.device))
        self._sources.append(("spindle",))

    # ------------------------------------------------------- fast path
    def enable_fast_path(self, sink_box=None, source_box=None,
                         uniform_e=(0.0, 0.0, 0.0),
                         rng_impl: str = "rbg") -> None:
        """Switch stepping to the analytic gather-free path
        (ops/analytic.py): B is recomputed at each particle from the
        recorded sources instead of gathered from the grid.

        ``sink_box`` = (r_max, z_min, z_max) and ``source_box`` = (r_lo,
        r_hi, z_lo, z_hi) in metres; the defaults reproduce the default
        scenario's wall sinks and source box (fusionsim.js:94-122).  A grid
        B, a grid E without ``uniform_e`` and non-analytic sources raise
        ValueError.  ``rng_impl`` names a JAX generator ('rbg', ...); here
        a true value re-seeds the shell's generator with 0, as the
        reference starts a fresh stream."""
        from ..ops.analytic import AnalyticScenario

        spec = self.spec
        loops = tuple((s[1], s[2], s[3]) for s in self._sources
                      if s[0] == "loop")
        bz = sum(s[1] for s in self._sources if s[0] == "bz")
        btheta = sum(s[1] for s in self._sources if s[0] == "btheta")
        line = sum(s[1] for s in self._sources if s[0] == "line")
        if any(s[0] == "grid_e" for s in self._sources) and not any(
                uniform_e):
            raise ValueError(
                "a grid E field was set; the fast path cannot sample it — "
                "pass uniform_e=(Er, Etheta, Ez) if the field is uniform, or "
                "stay in grid mode")
        if any(s[0] == "grid_b" for s in self._sources):
            raise ValueError(
                "a grid B field was set via set({'B': ...}); the fast path "
                "recomputes B analytically from recorded sources and would "
                "silently drop it — stay in grid mode")
        if any(s[0] not in ("loop", "bz", "btheta", "line", "grid_e")
               for s in self._sources):
            raise ValueError("fast path supports analytic sources only")
        if sink_box is None:
            sink_box = ((spec.nr - 1) / spec.nr * spec.radius,
                        spec.height / spec.nz,
                        (spec.nz - 1) / spec.nz * spec.height)
        if source_box is None:
            source_box = (0.0, spec.radius / 8,
                          7 * spec.height / 16, 9 * spec.height / 16)
        self._fast_scenario = AnalyticScenario(
            loops=loops, bz=bz, btheta=btheta, line_current=line,
            uniform_e=tuple(float(v) for v in uniform_e),
            sink_box=tuple(float(v) for v in sink_box),
            source_box=tuple(float(v) for v in source_box),
            # the default grid mask keeps the on-axis column at the z walls
            # (fusionsim.js:104-112: z-wall rows run r-cells 1..nr-2)
            axis_keep_r=spec.radius / spec.nr)
        if rng_impl:
            self.generator.manual_seed(0)

    def disable_fast_path(self) -> None:
        self._fast_scenario = None

    def _step_fast(self, n: int) -> None:
        from ..ops.analytic import FastState, make_fast_multi_step_fn

        run = make_fast_multi_step_fn(self.spec, self._fast_scenario, n)
        fs = run(FastState(self.state.position, self.state.velocity,
                           self.state.alive), self.generator)
        self.state = self.state._replace(position=fs.position,
                                         velocity=fs.velocity,
                                         alive=fs.alive)

    # ------------------------------------------------------- sorted path
    def enable_sorted_path(self, tiling=None, resort_every: int = 8,
                           spill_capacity: int | None = None,
                           backend: str = "xla",
                           rng_impl: str | None = None,
                           repair: bool = False,
                           repair_free_slots: int = 256,
                           respawn_capacity: int | None = None,
                           spill_tiers: tuple[int, ...] = ()) -> None:
        """Switch grid-parity stepping to the tile-sorted layout
        (models/pusher_sorted.py); the physics per particle is unchanged,
        the particle ORDER is not kept.  ``backend``: 'xla' (plain
        windowed gathers), 'pallas' (kernel B3) or 'fused' (kernel B2).

        ``spill_capacity=None`` sizes the per-substep patch buffer to the
        late-window peak of the out-of-window flux: ~0.4% of N per substep
        at the default cadence, scaled with ``resort_every``, floored at
        4096 and rounded up to a power of two.  Overflow rows FREEZE for
        the substep and count in ``dropped_over``; the respawn backlog
        counts in ``dropped``.  ``spill_tiers``: ascending smaller patch
        buffers (fused backend), the same result.

        ``rng_impl`` names a JAX generator ('rbg', ...); here it only
        re-seeds the shell's generator with 0, as the reference starts a
        fresh stream.  ``repair=True`` relocates the rows that left their
        window into their new tile every substep (``repair_free_slots``
        sizes each tile's stack); the full resort then runs every
        ``resort_every`` steps at a window's start, or after a ``step()``
        call whose ``unplaced`` count (read once a call) grew by more than
        max(64, capacity // 8) a step."""
        from .pusher_sorted import (Tiling2D, make_sorted_density_fn,
                                    make_sorted_resort_fn,
                                    make_sorted_step_fn, to_sorted_state)

        spec = self.spec
        if tiling is None:
            if backend == "fused":
                from ..ops.fused_pusher import stream_tiling_for
                tiling = stream_tiling_for(spec.nr, spec.nz, margin=6)
            else:
                # nr/nz must divide by the tiles; 400x800 -> 50x50 tiles
                candidates = (8, 16, 20, 25, 32, 40, 50)
                divs_r = [t for t in candidates if spec.nr % t == 0]
                divs_z = [t for t in candidates if spec.nz % t == 0]
                if not divs_r or not divs_z:
                    raise ValueError(
                        f"no default tile size in {candidates} divides the "
                        f"{spec.nr}x{spec.nz} grid — pass an explicit "
                        "Tiling2D(tile_r=..., tile_z=...) whose tiles "
                        "divide it")
                tiling = Tiling2D(tile_r=max(divs_r), tile_z=max(divs_z),
                                  block=1024, margin=4)
        if spill_capacity is None:
            frac = max(1, int(128 * 12 / max(1, resort_every)))
            spill_capacity = int(max(4096, 1 << int(np.ceil(np.log2(
                max(1, spec.n_total // frac))))))
        ts = check_tiers(spill_tiers, spill_capacity)
        # validates backend before any state changes
        self._sorted_step = make_sorted_step_fn(
            spec, tiling, spill_capacity, backend, repair=repair,
            respawn_capacity=respawn_capacity, spill_tiers=ts)
        if rng_impl is not None:
            self.generator.manual_seed(0)
        self._sorted_tiling = tiling
        self._sorted_resort_every = resort_every
        self._sorted_capacity = spill_capacity
        self._sorted_repair = repair
        self._sorted_free_slots = int(repair_free_slots)
        self._sorted_state = to_sorted_state(self.state, spec, tiling,
                                             reserve=repair)
        if repair:
            self._sorted_state = with_repair_state(
                self._sorted_state, self._sorted_n_tiles(), tiling.block,
                self._sorted_free_slots)
        self._sorted_density = make_sorted_density_fn(spec)
        self._sorted_resort = make_sorted_resort_fn(spec, tiling,
                                                    reserve=repair)
        self._sorted_since = 0
        self._sorted_unplaced_seen = 0
        self._sorted_need_resort = False

    def _sorted_n_tiles(self) -> int:
        return math.prod(self._sorted_tiling.n_tiles((self.spec.nr,
                                                      self.spec.nz)))

    def disable_sorted_path(self) -> None:
        """Return to the plain layout (live rows in layout order)."""
        from .pusher_sorted import from_sorted_state

        if self._sorted_state is not None:
            self.state = from_sorted_state(self._sorted_state, self.spec,
                                           PusherState)
            self._sorted_state = None

    def _sorted_step_once(self) -> None:
        st = self._sorted_state
        n_rows = st.position.shape[0]
        with span("kernel"):
            rands = [substep_uniforms(self.generator, n_rows, self.device)
                     for _ in range(2)]
        self._sorted_state = self._sorted_step(self.fields, st, rands)

    def _resort_sorted(self) -> None:
        with span("resort"):
            self._sorted_state = self._sorted_resort(self._sorted_state)
            if self._sorted_repair:
                self._sorted_state = with_free_list(
                    self._sorted_state, self._sorted_n_tiles(),
                    self._sorted_tiling.block, self._sorted_free_slots)

    def _step_sorted(self, n: int) -> None:
        """``run_cadence`` on the sorted layout: with repair a call ends
        with the drain check, sized by the patch buffer."""
        (self._sorted_since, self._sorted_need_resort,
         self._sorted_unplaced_seen) = run_cadence(
            n, self._sorted_since, self._sorted_need_resort,
            self._sorted_unplaced_seen,
            resort_every=self._sorted_resort_every,
            repair=self._sorted_repair, step_once=self._sorted_step_once,
            resort=self._resort_sorted, state=lambda: self._sorted_state,
            buffer=self._sorted_capacity, n_real=self.spec.n_total)

    # -------------------------------------------------------- simulation
    def precalc(self) -> None:
        """Recompute R1/R2/R3/A from E and B (empic.js:1413-1434)."""
        spec = self.spec
        self.fields = self.fields._replace(coeffs=precompute_rotation(
            self.fields.b, self.fields.e, spec.h, spec.factor_r,
            spec.factor_z))

    def step(self, n: int = 1) -> None:
        """Advance n full steps (each two half-steps, empic.js:1436-1469),
        drawing the uniforms from the shell's generator.

        The call is the ``fusion_sim.step`` span (``utils/profiling.span``:
        a profiler's annotation while one records, else the host clock's
        phase). On the sorted path its leaf phases ``kernel`` (the uniforms,
        the coefficient table and the substep itself), ``patch``,
        ``respawn``, ``finish`` and ``resort`` (models/pusher_sorted.py)
        hold every operation it launches, with ``host_read`` around each
        count read on the host, and it counts ``rows_patched`` and
        ``rows_respawned``."""
        with span("step"):
            if self._fast_scenario is not None:
                self._step_fast(n)
            elif self._sorted_state is not None:
                self._step_sorted(n)
            else:
                for _ in range(n):
                    rands = [substep_uniforms(self.generator,
                                              self.spec.n_total, self.device)
                             for _ in range(2)]
                    self.state = self._step(self.fields, self.state, rands)

    def density(self) -> torch.Tensor:
        """Deposit moments, update the EMA, render the frame
        (empic.js:1471-1526).  Returns (nr, nz, 3) float RGB.  The call is
        the leaf span ``fusion_sim.density``."""
        with span("density"):
            if self._sorted_state is not None:
                self._sorted_state, frame = self._sorted_density(
                    self.fields, self._sorted_state)
                return frame
            self.state, frame = self._density(self.fields, self.state)
            return frame

    # ---------------------------------------------------- checkpointing
    def get_state(self) -> dict[str, np.ndarray]:
        """Full state download: ``state.*`` and ``fields.*``; in place of
        the reference's ``state.key``, ``state.generator.<device type>``
        holds the generator's state (a CPU and a CUDA generator run other
        algorithms, so each restores only its own)."""
        out = {f"state.{k}": v.cpu().numpy()
               for k, v in self.state._asdict().items()}
        out[f"state.generator.{self.device.type}"] = (
            self.generator.get_state().numpy())
        for k, v in self.fields._asdict().items():
            if k == "coeffs":
                for ck, cv in v._asdict().items():
                    out[f"fields.coeffs.{ck}"] = cv.cpu().numpy()
            else:
                out[f"fields.{k}"] = v.cpu().numpy()
        return out

    def set_state(self, blob: dict[str, np.ndarray]) -> None:
        """Restore from ``get_state`` output of either package
        (``pusher_state_from_numpy``); a port blob taken on the same device
        type restores the generator too."""
        self.state, self.fields = pusher_state_from_numpy(blob, self.device)
        gen = blob.get(f"state.generator.{self.device.type}")
        if gen is not None:
            self.generator.set_state(torch.tensor(np.asarray(gen, np.uint8)))


def make_cylindrical_particle_pusher(spec: dict[str, Any],
                                     **kwargs) -> CylindricalParticlePusher:
    """Factory with the reference's name (empic.js:30)."""
    return CylindricalParticlePusher(spec, **kwargs)
