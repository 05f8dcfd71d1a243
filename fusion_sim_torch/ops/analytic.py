"""Analytic (gather-free) fast path of the static-field pusher (port of
``fusion_sim_tpu/ops/analytic.py``).

For static imposed fields, the reference's only live mode, B is evaluated
in closed form at each particle every substep (elliptic-integral loop
fields plus uniform and line terms), the sink is a geometric box test and
the source box is sampled straight from the uniforms: no gathers, no
scatters, ~400 flops a push, all elementwise.

Physics against grid mode: B at the exact particle position instead of the
NEAREST cell centre, with the same Boris algebra (the per-cell R1/R2/R3/A
precompute of empic.js:506-659 is the rotation computed from the gathered
B, which is what happens here per particle, metric corrections included).

The reference's state carries a PRNG key; the port's carries none.
``_substep`` takes the substep's (N, 4) uniforms as an argument, and
``make_fast_multi_step_fn`` draws them from a ``torch.Generator``.  On the
TPU XLA fuses the substep into one kernel; here it runs as plain PyTorch
elementwise operations (no kernel of the port's own).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..constants import MU_0, PI, SPEED_OF_LIGHT
from .fields import current_loop_b_exact
from .rng import substep_uniforms


@dataclasses.dataclass(frozen=True)
class AnalyticScenario:
    """Closed-form scenario description (all lengths in metres).

    ``loops``: (R, Z, I) current loops.  ``sink_box``: (r_max, z_min,
    z_max), particles outside are absorbed (the default wall sinks,
    fusionsim.js:103-112).  ``source_box``: (r_lo, r_hi, z_lo, z_hi), the
    uniform respawn box (fusionsim.js:114-122).  ``axis_keep_r`` > 0 keeps
    particles with r < axis_keep_r at the z walls (the default mask's z-wall
    rows run r-cells 1..nr-2); they are still absorbed at the r wall.
    """

    loops: tuple[tuple[float, float, float], ...] = ()
    bz: float = 0.0
    btheta: float = 0.0
    line_current: float = 0.0
    uniform_e: tuple[float, float, float] = (0.0, 0.0, 0.0)  # (E_r, E_th, E_z)
    sink_box: tuple[float, float, float] = (1.0, 0.0, 2.0)
    source_box: tuple[float, float, float, float] = (0.0, 0.125, 0.875, 1.125)
    axis_keep_r: float = 0.0


def _f32(value: float) -> float:
    """A Python float rounded to f32, as the reference's ``jnp.float32``."""
    return float(torch.tensor(value, dtype=torch.float32))


def b_field_at(scenario: AnalyticScenario, r: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """(B_r, B_theta, B_z) at physical (r, z): the sources superposed."""
    total = torch.zeros(r.shape + (3,), dtype=torch.float32, device=r.device)
    for loop_r, loop_z, current in scenario.loops:
        total = total + current_loop_b_exact(r, z, loop_r, loop_z, current)
    if scenario.bz:
        total[..., 2] += _f32(scenario.bz)
    if scenario.btheta or scenario.line_current:
        btheta = torch.full_like(r, _f32(scenario.btheta))
        if scenario.line_current:
            btheta = btheta + scenario.line_current * MU_0 / (
                2.0 * PI * torch.clamp(r, min=1e-9))
        total[..., 1] += btheta
    return total


class FastState(NamedTuple):
    position: torch.Tensor  # (N, 3) normalized (like PusherState)
    velocity: torch.Tensor
    alive: torch.Tensor


def _substep(spec, scenario: AnalyticScenario, state: FastState,
             rand: torch.Tensor) -> FastState:
    """One half-step, all elementwise: velocity, then position, on this
    substep's (N, 4) uniforms ``rand``.  ``ops.boris.push_velocity`` +
    ``ops.push.push_position`` with the grid lookups replaced by closed
    forms; ``spec`` is a PusherSpec."""
    x, y, z = state.position.unbind(-1)
    r = torch.sqrt(x * x + y * y)
    dir_x = x / r
    dir_y = y / r

    # velocity push: the Boris rotation from the analytic B
    b = b_field_at(scenario, r * spec.radius, z * spec.height)
    bx, by, bz = b.unbind(-1)
    h = _f32(spec.h)
    hb2 = h * h * (bx * bx + by * by + bz * bz)
    f = 2.0 / (1.0 + hb2)
    diag = 1.0 - hb2 * f
    rz = _f32(spec.factor_r / spec.factor_z)
    zr = _f32(spec.factor_z / spec.factor_r)

    vx, vy, vz = state.velocity.unbind(-1)
    vr = vx * dir_x + vy * dir_y
    va = vy * dir_x - vx * dir_y

    nvr = (diag + f * h * h * bx * bx) * vr \
        + (f * h * (bz + h * bx * by)) * va \
        + (f * h * (-by + h * bx * bz) * rz) * vz
    nva = (f * h * (-bz + h * by * bx)) * vr \
        + (diag + f * h * h * by * by) * va \
        + (f * h * (bx + h * by * bz) * rz) * vz
    nvz = (f * h * (by + h * bz * bx) * zr) * vr \
        + (f * h * (-bx + h * bz * by) * zr) * va \
        + (diag + f * h * h * bz * bz) * vz

    if any(scenario.uniform_e):
        # the acceleration A of programPreA (empic.js:625-659), with the
        # reference's scalar h*(E.B) broadcast quirk reproduced
        ex, ey, ez = (_f32(v) for v in scenario.uniform_e)
        e_dot_b = ex * bx + ey * by + ez * bz
        exb_r = ey * bz - ez * by
        exb_a = ez * bx - ex * bz
        exb_z = ex * by - ey * bx
        pref = h * (2.0 - hb2 * f)
        ar = (pref * ex + h * h * f * (exb_r + h * e_dot_b)) / SPEED_OF_LIGHT
        aa = (pref * ey + h * h * f * (exb_a + h * e_dot_b)) / SPEED_OF_LIGHT
        az = (pref * ez + h * h * f * (exb_z + h * e_dot_b)) / SPEED_OF_LIGHT
        nvr = nvr + ar * _f32(spec.factor_r)
        nva = nva + aa * _f32(spec.factor_r)
        nvz = nvz + az * _f32(spec.factor_z)

    new_vx = nvr * dir_x - nva * dir_y
    new_vy = nvr * dir_y + nva * dir_x

    # just-respawned particles get thermal velocities (empic.js:771-772)
    fresh = state.alive <= 0.5
    thermal = 0.001 * (2.0 * rand[:, :3] - 1.0)
    new_vx = torch.where(fresh, thermal[:, 0], new_vx)
    new_vy = torch.where(fresh, thermal[:, 1], new_vy)
    nvz = torch.where(fresh, thermal[:, 2], nvz)

    # position push, geometric sink and box-source respawn
    sf = _f32(spec.step_factor)
    px = x + sf * new_vx
    py = y + sf * new_vy
    pz = z + sf * nvz
    pr = torch.sqrt(px * px + py * py)

    r_max, z_min, z_max = scenario.sink_box
    r_phys_new = pr * spec.radius
    z_phys_new = pz * spec.height
    keep_z = (z_phys_new > z_min) & (z_phys_new < z_max)
    if scenario.axis_keep_r > 0.0:
        keep_z = keep_z | (r_phys_new < scenario.axis_keep_r)
    keep = (r_phys_new < r_max) & keep_z

    r_lo, r_hi, z_lo, z_hi = scenario.source_box
    # normalized respawn coordinates (the inverse CDF of a box is affine)
    new_r = (r_lo + (r_hi - r_lo) * rand[:, 0]) * spec.factor_r
    new_z = (z_lo + (z_hi - z_lo) * rand[:, 1]) * spec.factor_z

    out_x = torch.where(keep, px, new_r)
    out_y = torch.where(keep, py, 0.0)
    out_z = torch.where(keep, pz, new_z)
    return FastState(position=torch.stack([out_x, out_y, out_z], dim=-1),
                     velocity=torch.stack([new_vx, new_vy, nvz], dim=-1),
                     alive=keep.to(torch.float32))


def make_fast_multi_step_fn(spec, scenario: AnalyticScenario, n_steps: int):
    """``run(state, generator) -> state``: ``n_steps`` full steps (two
    substeps each), drawing every substep's uniforms from ``generator`` (a
    plain loop: PyTorch runs eagerly)."""

    def run(state: FastState, generator: torch.Generator) -> FastState:
        n, dev = state.position.shape[0], state.position.device
        for _ in range(2 * n_steps):
            state = _substep(spec, scenario, state,
                             substep_uniforms(generator, n, dev))
        return state

    return run


def default_scenario(radius: float = 1.0, height: float = 2.0,
                     nr: int = 400, nz: int = 800) -> AnalyticScenario:
    """The reference's default scenario as closed forms
    (fusionsim.js:94-138): wall sinks one cell inside the r/z extremes,
    source box r-cells [0, 50), z-cells [350, 450) of the 400 x 800 grid,
    mirror coils at r = 0.8, z in {0, height}."""
    return AnalyticScenario(
        loops=((0.8 * radius, height, -1e7), (0.8 * radius, 0.0, 1e7)),
        sink_box=((nr - 1) / nr * radius, height / nz,
                  (nz - 1) / nz * height),
        source_box=(0.0, 50 / 400 * radius, 350 / 800 * height,
                    450 / 800 * height),
        axis_keep_r=radius / nr)
