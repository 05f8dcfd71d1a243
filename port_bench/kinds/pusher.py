"""The app's test-particle pusher, one animation frame a step:
``fusion_sim_torch.models.pusher.CylindricalParticlePusher`` on its
tile-sorted path (``enable_sorted_path``, the configuration's ``shell``),
where ``step(1)`` of the model here is the app's frame, the pusher's
``step(1)`` (two half-steps) and then its ``density()`` (fusionsim.js:
170-202).  The frame stays on the device, as the app's canvas does.

Coordinates.  The pusher works in normalized Cartesian (x / radius,
y / radius, z / height), velocities in units of c scaled alike; the
harness compares rows in the grid frame.  So the load (``inputs``) is
drawn as the app draws it, a cube of positions and a cube of
velocities (``traffic["cube"]``, ``traffic["populations"][0]``), and
given in the grid frame, x = (r / dr, z / dz), with v = (v_r, v_theta,
v_z) in units of c; ``build`` places each row at theta = 0 with that
velocity, and ``snapshot`` converts back.  B, the sinks and the source
are axisymmetric, and the app respawns every row at theta = 0
(``ops/push.sink_respawn``), so this is the app's load in every quantity
the scenario reads: a rotation about the axis changes none of them.

Numbers that decide ``correct`` beside the common ones (``check.py``;
rows are compared through their moments in the grid frame):

- ``density``: a checked frame's EMA grid (``moments_avg``) against the
  reference's, from the same EMA before the frame: the count channel at
  every cell, the mean velocities where this frame's count is at least
  1e-12 of its largest (``_density_gap``);
- ``frame``: the RGB frame's change over the frame against the
  reference's: the |B| layer, which the app builds in float32 sums that
  lose up to 2% beside the loops (``reference/pusher.py``), cancels;
- ``speed``: max over rows alive before the frame and absorbed in
  neither half-step of ||v| after - |v| before| / |v| before, |v| in
  physical units: E is zero, so the Boris rotation keeps |v|;
- ``contained``: after a step, rows whose sample cell (the app's nearest
  cell, clamped to the grid) is a sink cell: an exact 0, every row that
  reached an absorbing wall respawned.  Rows that left through the
  on-axis column of the z walls, which the app leaves open
  (fusionsim.js:103-112), are the app's and are not counted.

The reference (``reference/pusher.py``) is handed the frame's uniforms:
``snapshot`` draws them from a clone of the shell's generator exactly as
the next ``step(1)`` will, and takes each row's from the slot the row
will hold then (after the resort that opens the frame, where one is due).
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from .. import check
from ..reference import pusher as ref_pusher


def _spec(config: dict) -> dict:
    phys = config["physics"]
    nr, nz = phys["grid_shape"]
    side = math.isqrt(int(config["n_particles"]))
    if side * side != int(config["n_particles"]):
        raise ValueError("the app's particle count is a square")
    return {"radius": phys["radius"], "height": phys["height"], "nr": nr,
            "nz": nz, "dt": phys["dt"], "nparticles": side,
            "particle_mass": phys["particle_mass"],
            "particle_charge": phys["particle_charge"]}


def inputs(config: dict, traffic: dict, seed: int, device
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The app's load (fusionsim.js:124-128): positions uniform in a cube
    of side ``cube["side_m"]`` centred on the axis at ``cube["centre_z_m"]``
    and velocities uniform in +-``v_max_c`` per Cartesian component, from
    one generator seeded with ``seed``; in the grid frame."""
    phys = config["physics"]
    nr, nz = phys["grid_shape"]
    n = int(config["n_particles"])
    cube = traffic["cube"]
    (pop,) = traffic["populations"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    p = float(cube["side_m"]) * (torch.rand((n, 3), generator=g,
                                            device=device) - 0.5)
    v = 2.0 * float(pop["v_max_c"]) * (torch.rand(
        (n, 3), generator=g, device=device) - 0.5)
    z = p[:, 2] + float(cube["centre_z_m"])
    r = torch.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1])
    safe = torch.where(r > 0, r, 1.0)
    cx = torch.where(r > 0, p[:, 0] / safe, 1.0)
    cy = torch.where(r > 0, p[:, 1] / safe, 0.0)
    x = torch.stack([r * (nr / phys["radius"]), z * (nz / phys["height"])],
                    dim=-1)
    vel = torch.stack([v[:, 0] * cx + v[:, 1] * cy,
                       v[:, 1] * cx - v[:, 0] * cy, v[:, 2]], dim=-1)
    return x, vel


class AppFrames:
    """The app's frame loop: ``step(n)`` runs n frames, each the pusher's
    ``step(1)`` and then its ``density()``; the last frame stays on the
    device in ``frame``."""

    def __init__(self, sim):
        self.sim = sim
        self.frame = None

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self.sim.step(1)
            self.frame = self.sim.density()


def build(config: dict, layout: dict, pos: np.ndarray, vel: np.ndarray,
          device):
    """The pusher through its public constructor and set-up methods
    (``set``, ``add_current_loop``, ``precalc``, ``enable_sorted_path``)
    on the app's scenario, the rows at theta = 0.  The shell's generator,
    which draws the uniforms, is seeded from the load's bytes, and so from
    the run's seed."""
    from fusion_sim_torch.models.pusher import CylindricalParticlePusher
    from fusion_sim_torch.ops.sorted_deposit import Tiling2D
    from fusion_sim_torch.scenarios import default_scenario_arrays

    phys = config["physics"]
    spec = _spec(config)
    nr, nz = spec["nr"], spec["nz"]
    dr, dz = phys["radius"] / nr, phys["height"] / nz
    sim = CylindricalParticlePusher(
        spec, seed=zlib.crc32(np.ascontiguousarray(pos).tobytes()),
        device=device)
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    zeros = np.zeros(pos.shape[0])
    scene = default_scenario_arrays({"nr": nr, "nz": nz, "nparticles": 1,
                                     "height": phys["height"]})
    sim.set({"position": np.stack([pos[:, 0] * dr, zeros, pos[:, 1] * dz],
                                  -1),
             "velocity": vel, "sink_mask": scene["sink_mask"],
             "source_pdf": scene["source_pdf"]})
    for r_m, z_m, current in phys["coils"]:
        sim.add_current_loop(r_m, z_m, current)
    sim.precalc()
    t = config["tiling"]
    sim.enable_sorted_path(
        tiling=Tiling2D(tile_r=t["tile"][0], tile_z=t["tile"][1],
                        block=t["block"], margin=t["margin"]),
        **config["shell"], **layout["shell"])
    return AppFrames(sim)


def _resort_due(sim) -> bool:
    return sim._sorted_since >= sim._sorted_resort_every \
        or sim._sorted_need_resort


def _next_slots(sim, st) -> torch.Tensor:
    """The slot each row of the layout ``st`` will hold when the next
    ``step(1)`` pushes it: its own, or where the resort that opens the
    step puts it (the shell's resort run on a copy whose velocities carry
    the slot numbers, exact in float32)."""
    n_rows = st.position.shape[0]
    slots = torch.arange(n_rows, device=st.position.device)
    if not _resort_due(sim):
        return slots
    if n_rows >= 1 << 24:
        raise ValueError("slot numbers past float32's integers")
    tag = slots.to(torch.float32)[:, None].expand(n_rows, 3).contiguous()
    moved = sim._sorted_resort(st._replace(velocity=tag))
    src = moved.velocity[moved.valid, 0].to(torch.int64)
    out = torch.full_like(slots, -1)
    out[src] = torch.nonzero(moved.valid)[:, 0]
    return out


def snapshot(app) -> dict:
    """The real rows in the grid frame (``x``, ``v``) and the app's own
    (``pos``, ``vel`` normalized, ``alive``), their slots now and at the
    next push, the EMA grid, the last frame and the next frame's uniforms
    for these rows, copied."""
    from fusion_sim_torch.ops.rng import substep_uniforms

    sim = app.sim
    st = sim._sorted_state
    spec = sim.spec
    valid = st.valid
    pos, vel = st.position[valid], st.velocity[valid]
    held = torch.nonzero(valid)[:, 0]
    nxt = _next_slots(sim, st)[held]
    g = torch.Generator(device=sim.device)
    g.set_state(sim.generator.get_state())
    rands = torch.stack([substep_uniforms(g, st.position.shape[0],
                                          sim.device) for _ in range(2)])
    snap = {"pos": pos.clone(), "vel": vel.clone(),
            "alive": st.alive[valid].clone(), "slot": held, "next": nxt,
            "avg": st.moments_avg.clone(), "rand": rands[:, nxt]}
    snap.update(grid_frame(pos, vel, spec.radius, spec.height, spec.nr,
                           spec.nz))
    if app.frame is not None:
        snap["frame"] = app.frame.clone()
    return snap


def grid_frame(pos: torch.Tensor, vel: torch.Tensor, radius: float,
               height: float, nr: int, nz: int) -> dict:
    """Normalized Cartesian rows as ``x`` = (r / dr, z / dz) and ``v`` =
    (v_r, v_theta, v_z) in units of c; a row at r = 0 takes theta = 0."""
    x, y = pos[:, 0].double(), pos[:, 1].double()
    r = torch.sqrt(x * x + y * y)
    safe = torch.where(r > 0, r, 1.0)
    cx = torch.where(r > 0, x / safe, 1.0)
    cy = torch.where(r > 0, y / safe, 0.0)
    v = vel.double() * torch.tensor([radius, radius, height],
                                    dtype=torch.float64, device=vel.device)
    return {"x": torch.stack([r * nr, pos[:, 2].double() * nz],
                             dim=-1).float(),
            "v": torch.stack([v[:, 0] * cx + v[:, 1] * cy,
                              v[:, 1] * cx - v[:, 0] * cy, v[:, 2]],
                             dim=-1).float()}


def dropped(app) -> int:
    """Respawns past the respawn buffer and rows frozen past the patch
    buffer, since the build."""
    st = app.sim._sorted_state
    return int(st.dropped) + int(st.dropped_over)


def reference_after(config: dict, before: dict,
                    fdtype: torch.dtype = torch.float32) -> dict:
    """The reference's frame from a snapshot, as a snapshot (float32)."""
    phys = config["physics"]
    out = ref_pusher.frame(phys, before["pos"], before["vel"],
                           before["alive"], before["avg"], before["rand"],
                           fdtype)
    nr, nz = phys["grid_shape"]
    out.update(grid_frame(out["pos"], out["vel"], phys["radius"],
                          phys["height"], nr, nz))
    out["slot"] = before["next"]
    return out


def _density_gap(avg: torch.Tensor, ref: dict) -> float:
    """``check.gap`` of the EMA grid: the count channel at every cell, the
    mean-velocity channels at the cells that this frame's count reaches
    above 1e-12 of its largest.  Below that only the bell's outermost
    pixels reach a cell (weight ~1e-34), whose velocity products are
    subnormal in float32, and the mean there is rounding."""
    counted = ref["count"] >= 1e-12 * ref["count"].max()
    return max(check.gap(avg[..., 3:], ref["avg"][..., 3:]),
               check.gap(avg[counted][:, :3], ref["avg"][counted][:, :3]))


def _speed(phys: dict, vel: torch.Tensor) -> torch.Tensor:
    scale = torch.tensor([phys["radius"], phys["radius"], phys["height"]],
                         dtype=torch.float64, device=vel.device)
    return torch.linalg.vector_norm(vel.double() * scale, dim=-1)


def step_numbers(config: dict, after: dict, ref: dict,
                 before: dict) -> dict[str, float]:
    phys = config["physics"]
    shape = tuple(phys["grid_shape"])
    out = check.rows_gap(after, ref["x"], ref["v"], shape,
                         int(config["n_particles"]))
    out["density"] = _density_gap(after["avg"], ref)
    change = after["frame_change"] if "frame_change" in after \
        else after["frame"] - before["frame"]
    out["frame"] = check.gap(change, ref["frame_change"])
    # the rows of ``after`` by the slot each pushed row holds, against
    # those of ``before`` by the slot it was pushed in
    if after["slot"].shape != before["next"].shape:
        out["speed"] = 1.0
        return out
    order_a = torch.argsort(after["slot"])
    order_b = torch.argsort(before["next"])
    if not torch.equal(after["slot"][order_a], before["next"][order_b]):
        out["speed"] = 1.0
        return out
    keep = ref["survived"][order_b]
    s0 = _speed(phys, before["vel"][order_b])[keep]
    s1 = _speed(phys, after["vel"][order_a])[keep]
    out["speed"] = float(((s1 - s0).abs() / s0).max()) if s0.numel() else 0.0
    return out


def end_numbers(config: dict, end: dict, x_in: torch.Tensor,
                v_in: torch.Tensor) -> dict[str, float]:
    phys = config["physics"]
    nr, nz = phys["grid_shape"]
    sink = ref_pusher.sink_mask(phys, end["pos"].device)
    x, y, z = end["pos"][:, 0], end["pos"][:, 1], end["pos"][:, 2]
    r = torch.sqrt(x * x + y * y)
    ir = torch.clamp(torch.floor(r * nr).to(torch.int64), 0, nr - 1)
    iz = torch.clamp(torch.floor(z * nz).to(torch.int64), 0, nz - 1)
    return {"contained": float((sink[ir, iz] <= 0.5).sum())}
