"""Spindle-cusp conductor boundary-element solver (port of
``fusion_sim_tpu/models/spindle.py``).

The reference's spindle.js (makeSpindleCuspPlasmaField, spindle.js:31-656)
is unfinished dead code; its intent, as the JAX package completes it:

* a perfectly conducting (flux-excluding) boundary — a circular arc of
  radius ``radius*sqrt(1+a^2)``, a = 0.4, centred at (radius, 0), from the
  axis at z = 0.4*radius to the midplane (spindle.js:140-158), mirrored
  antisymmetrically about z = height/2 (spindle.js:558-614);
* in the field of two opposed fixed coils (+I at z=0, -I at z=height,
  r=radius; spindle.js:504-523);
* surface currents discretized into loops on the arc, solved so that the
  normal component of B vanishes at collocation points:
  A x = b, A[p, l] = B_n at point p per unit current in loop l,
  b[p] = -B_n of the fixed coils (spindle.js:632-636).

The completion notes of the reference module hold here too (corrected
angle spacing, single-loop basis, exact elliptic-integral element fields
through ``ops/fields.current_loop_b_exact``).  The geometry is built in
numpy float64 and cast to f32; the direct solve is a host solve in
float64; ``method='jacobi'`` runs the ported ``weighted_jacobi``.  Every
entry point runs on the CUDA card unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.fields import current_loop_b_exact, grid_coords

# elements a grid-field chunk evaluates at once: 8 M points x 3 components
# of f32 (~100 MB a temporary) keep the 256 loops of n_power 3 on a
# 400 x 800 grid to 16 chunks
_CHUNK_POINTS = 1 << 23


class SpindleGeometry(NamedTuple):
    points: torch.Tensor    # (n, 2) collocation points (r, z), metres
    normals: torch.Tensor   # (n, 2) outward normals (n_r, n_z)
    loops: torch.Tensor     # (n, 2) basis loop positions (r, z)


def build_geometry(radius: float, height: float, n_loops: int,
                   a: float = 0.4, device=None) -> SpindleGeometry:
    """Arc geometry of spindle.js:140-198 (angle spacing corrected).

    The arc: centre (radius, 0), radius R = radius*sqrt(1+a^2), parameter
    phi in [pi + alpha, pi + alpha + (pi/2 - 2*alpha)], alpha = atan(a);
    point (R*cos(-phi) + radius, R*sin(-phi)), normal (-cos(-phi),
    -sin(-phi)) (spindle.js:154-158).  Collocation points at half-integer
    angles (l + 0.5); basis loops strictly inside the arc at (l+1)/(n+1)
    fractions of it, keeping the reference's point/loop offset."""
    dev = resolve_device(device)
    big_r = radius * np.sqrt(1 + a * a)
    alpha = np.arctan(a)
    theta = alpha + np.pi
    arc = 0.5 * np.pi - 2.0 * alpha

    def arc_point(phi):
        return np.stack([big_r * np.cos(-phi) + radius,
                         big_r * np.sin(-phi)], axis=-1)

    p = np.arange(n_loops)
    phi_pts = (p + 0.5) * arc / n_loops + theta
    normals = np.stack([-np.cos(-phi_pts), -np.sin(-phi_pts)], axis=-1)
    phi_loops = (p + 1.0) * arc / (n_loops + 1.0) + theta

    def f32(x):
        return torch.as_tensor(x.astype(np.float32), device=dev)

    return SpindleGeometry(points=f32(arc_point(phi_pts)),
                           normals=f32(normals),
                           loops=f32(arc_point(phi_loops)))


def element_field(r: torch.Tensor, z: torch.Tensor, loop: torch.Tensor,
                  height: float) -> torch.Tensor:
    """Field of unit-current mirrored-loop basis elements at (r, z): +loop
    at z_l, -loop at height - z_l (the antisymmetric cusp pairing of
    spindle.js:577-590).  ``loop`` is (..., 2) and broadcasts against r
    and z, so one call can evaluate many elements."""
    r0 = torch.clamp(loop[..., 0], min=1e-4)
    z0 = loop[..., 1]
    return (current_loop_b_exact(r, z, r0, z0, 1.0)
            - current_loop_b_exact(r, z, r0, height - z0, 1.0))


def coil_field(r: torch.Tensor, z: torch.Tensor, radius: float,
               height: float, current: float) -> torch.Tensor:
    """The two fixed external coils: +I at z=0, -I at z=height, r=radius
    (spindle.js:504-523)."""
    return (current_loop_b_exact(r, z, radius, 0.0, current)
            + current_loop_b_exact(r, z, radius, height, -current))


def _normal_component(normals: torch.Tensor, field: torch.Tensor
                      ) -> torch.Tensor:
    return normals[..., 0] * field[..., 0] + normals[..., 1] * field[..., 2]


def _bem_matrix(geom: SpindleGeometry, height: float) -> torch.Tensor:
    """A[p, l] = n_p . B(element_l; point_p): points (n, 1) broadcast
    against loops (1, n) — the reference's double vmap."""
    pts = geom.points[:, None, :]
    f = element_field(pts[..., 0], pts[..., 1], geom.loops[None], height)
    return _normal_component(geom.normals[:, None, :], f)


def solve_surface_currents(
    radius: float, height: float, coil_current: float,
    n_loops: int = 256, method: str = "direct",
    tolerance: float = 1e-3, max_iterations: int = 10, device=None,
) -> tuple[SpindleGeometry, torch.Tensor, dict]:
    """Solve A x = b for the flux-excluding surface currents.

    Returns (geometry, currents, info).  ``method='jacobi'`` reproduces the
    reference's solver call (tol 1e-3, <=10 iterations, spindle.js:632-636).
    """
    if method not in ("direct", "jacobi"):
        raise ValueError(f"unknown method {method!r}")
    geom = build_geometry(radius, height, n_loops, device=device)
    a = _bem_matrix(geom, height)
    incident = coil_field(geom.points[:, 0], geom.points[:, 1],
                          radius, height, coil_current)
    b = -_normal_component(geom.normals, incident)

    if method == "direct":
        # a config-time host solve in float64 (f32 triangular solves lose
        # ~2 digits on the BEM matrix), as the reference does
        x = np.linalg.solve(a.cpu().numpy().astype(np.float64),
                            b.cpu().numpy().astype(np.float64))
        currents = torch.as_tensor(x.astype(np.float32),
                                   device=geom.points.device)
        info = {"method": "direct"}
    else:
        from ..ops.solvers import weighted_jacobi

        out = weighted_jacobi(a, b, tolerance=tolerance,
                              max_iterations=max_iterations)
        currents = out.result
        info = {"method": "jacobi", "iterations": out.iterations,
                "diff": float(out.diff),
                "correlation": float(out.correlation)}
    return geom, currents, info


def _physical_grid(radius: float, height: float, nr: int, nz: int,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """(r, z) in metres at the texel centres of the pusher's grid."""
    u, v = grid_coords(nr, nz, device)
    return (torch.broadcast_to(u * radius, (nr, nz)),
            torch.broadcast_to(v * height, (nr, nz)))


def grid_field(geom: SpindleGeometry, currents: torch.Tensor, radius: float,
               height: float, nr: int, nz: int) -> torch.Tensor:
    """Sum of ``currents[l] * element_l`` on the (nr, nz) normalized grid.

    Elements are evaluated a chunk of loops at a time; the f32 sum adds
    them one by one in loop order, as the reference's ``lax.scan`` does."""
    dev = geom.points.device
    r_phys, z_phys = _physical_grid(radius, height, nr, nz, dev)
    total = torch.zeros((nr, nz, 3), dtype=torch.float32, device=dev)
    n = geom.loops.shape[0]
    chunk = max(1, min(n, _CHUNK_POINTS // (nr * nz)))
    for lo in range(0, n, chunk):
        loops = geom.loops[lo:lo + chunk, None, None, :]
        fields = element_field(r_phys, z_phys, loops, height)
        fields = currents[lo:lo + chunk, None, None, None] * fields
        for k in range(fields.shape[0]):
            total = total + fields[k]
    return total


def spindle_cusp_field(
    radius: float, height: float, nr: int, nz: int,
    coil_current: float, n_power: int = 3, method: str = "direct",
    include_coils: bool = False, device=None,
) -> torch.Tensor:
    """Grid field of the solved surface currents (the superposition loop of
    spindle.js:639-654), on the (nr, nz) normalized grid of the pusher.

    ``n_power`` sizes the system like the reference's solver coupling:
    n_loops = 4*(2^n_power)^2 (matrix_webgl.js:44-54 via spindle.js:64).
    Returns (nr, nz, 3) with components (B_r, B_theta, B_z); add it to the
    pusher's B (the intent of empic.js:1369-1378)."""
    n_loops = 4 * (2 ** n_power) ** 2
    geom, currents, _ = solve_surface_currents(
        radius, height, coil_current, n_loops=n_loops, method=method,
        device=device)
    total = grid_field(geom, currents, radius, height, nr, nz)
    if include_coils:
        r_phys, z_phys = _physical_grid(radius, height, nr, nz, total.device)
        total = total + coil_field(r_phys, z_phys, radius, height,
                                   coil_current)
    return total
