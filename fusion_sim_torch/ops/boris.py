"""Boris rotation precompute and velocity push (port of
``fusion_sim_tpu/ops/boris.py``).

The reference precomputes, per grid cell, the three rows R1, R2, R3 of the
Boris rotation matrix plus the acceleration vector A whenever the fields
change (``programPre1/2/3/A``, empic.js:506-659), so the per-particle
velocity update is a nearest-cell gather plus three dot products
(``step_velocity_frag``, empic.js:729-778).

Every expression keeps the reference's operation order in f32 (the three
dot products are written out left to right), so the two packages agree to
f32 rounding and the fused kernel (ops/fused_pusher.py) agrees with the
patch path bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import SPEED_OF_LIGHT


class BorisCoefficients(NamedTuple):
    """Per-cell pusher coefficients, each ``(nr, nz, 3)``: r1, r2, r3 are
    the rows of the Boris rotation (cylindrical frame), a the acceleration
    (normalized units)."""

    r1: torch.Tensor
    r2: torch.Tensor
    r3: torch.Tensor
    a: torch.Tensor


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0*b0 + a1*b1) + a2*b2 over the last axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def precompute_rotation(b_field: torch.Tensor, e_field: torch.Tensor,
                        h: float, factor_r: float,
                        factor_z: float) -> BorisCoefficients:
    """R1, R2, R3, A from the grid fields (empic.js:506-659), with
    h = q*dt/(2m):

        hB2  = h^2 |B|^2,  f = 2 / (1 + hB2)
        R_ii = (1 - hB2*f) + f*h^2*B_i^2,  R_ij = f*h*(±B_k + h*B_i*B_j)
        A    = (h*(2 - hB2*f)*E + h^2*f*(E×B + h*(E·B))) / c

    with the metric corrections factor_r/factor_z on the z couplings and A
    scaled per axis.  The reference's A adds the *scalar* h*(E·B) to every
    component of E×B (a GLSL scalar broadcast, empic.js:652); kept."""
    b = b_field.to(torch.float32)
    e = e_field.to(torch.float32)
    h = torch.tensor(h, dtype=torch.float32)
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    bmag2 = bx * bx + by * by + bz * bz
    hb2 = h * h * bmag2
    factor = 2.0 / (1.0 + hb2)
    diag = 1.0 - hb2 * factor

    rz = torch.tensor(factor_r / factor_z, dtype=torch.float32)
    zr = torch.tensor(factor_z / factor_r, dtype=torch.float32)

    r11 = diag + factor * h * h * bx * bx
    r12 = factor * h * (bz + h * bx * by)
    r13 = factor * h * (-by + h * bx * bz) * rz
    r21 = factor * h * (-bz + h * by * bx)
    r22 = diag + factor * h * h * by * by
    r23 = factor * h * (bx + h * by * bz) * rz
    r31 = factor * h * (by + h * bz * bx) * zr
    r32 = factor * h * (-bx + h * bz * by) * zr
    r33 = diag + factor * h * h * bz * bz

    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    e_cross_b = torch.stack([ey * bz - ez * by, ez * bx - ex * bz,
                             ex * by - ey * bx], dim=-1)
    e_dot_b = _dot3(e, b)[..., None]
    a = (h * (2.0 - hb2 * factor)[..., None] * e
         + (h * h * factor)[..., None] * (e_cross_b + h * e_dot_b)
         ) / SPEED_OF_LIGHT
    scale = torch.tensor([factor_r, factor_r, factor_z], dtype=torch.float32,
                         device=a.device)
    a = a * scale
    return BorisCoefficients(
        r1=torch.stack([r11, r12, r13], dim=-1),
        r2=torch.stack([r21, r22, r23], dim=-1),
        r3=torch.stack([r31, r32, r33], dim=-1),
        a=a)


def _nearest_index(u: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(torch.floor(u * n).to(torch.int64), 0, n - 1)


def gather_nearest(field: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """``(nr, nz, C)`` field values at normalized (u, v) per particle:
    NEAREST/CLAMP, the reference's texture filtering (utilities.js:556-560).
    """
    nr, nz = field.shape[0], field.shape[1]
    return field[_nearest_index(u, nr), _nearest_index(v, nz)]


def gather_bilinear(field: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Bilinear/CLAMP gather of ``(nr, nz, C)`` at normalized (u, v):
    texel-centre LINEAR filtering with clamp-to-edge, the opt-in variant of
    the reference's NEAREST sampling (``PusherSpec.interp='bilinear'``)."""
    nr, nz = field.shape[0], field.shape[1]
    tu = u * nr - 0.5
    tv = v * nz - 0.5
    iu0 = torch.clamp(torch.floor(tu).to(torch.int64), 0, nr - 1)
    iv0 = torch.clamp(torch.floor(tv).to(torch.int64), 0, nz - 1)
    iu1 = torch.clamp(iu0 + 1, max=nr - 1)
    iv1 = torch.clamp(iv0 + 1, max=nz - 1)
    fu = torch.clamp(tu - torch.floor(tu), 0.0, 1.0)[..., None]
    fv = torch.clamp(tv - torch.floor(tv), 0.0, 1.0)[..., None]
    f00, f01 = field[iu0, iv0], field[iu0, iv1]
    f10, f11 = field[iu1, iv0], field[iu1, iv1]
    return ((1 - fu) * (1 - fv) * f00 + (1 - fu) * fv * f01
            + fu * (1 - fv) * f10 + fu * fv * f11)


def pack_coefficients(coeffs: BorisCoefficients) -> torch.Tensor:
    """The (nr, nz, 12) R1|R2|R3|A table the 12-channel gathers sample."""
    return torch.cat([coeffs.r1, coeffs.r2, coeffs.r3, coeffs.a], dim=-1)


def push_velocity(position: torch.Tensor, velocity: torch.Tensor,
                  alive: torch.Tensor, rand: torch.Tensor,
                  coeffs: BorisCoefficients,
                  interp: str = "nearest") -> torch.Tensor:
    """One velocity half-kick for all particles (empic.js:729-778): rotate
    into the local cylindrical frame, gather R1/R2/R3/A at the particle's
    (r, z) cell, v+ = (R1·v, R2·v, R3·v) + A, rotate back; rows just
    respawned (alive ≈ 0) are instead re-initialized thermally to
    0.001 * U(-1, 1)^3 from this substep's uniforms.

    ``position``/``velocity`` (N, 3) normalized, ``alive`` (N,), ``rand``
    (N, >=3) uniforms; ``interp`` 'nearest' (reference parity) or
    'bilinear'."""
    x, y, z = position[..., 0], position[..., 1], position[..., 2]
    r = torch.sqrt(x * x + y * y)
    packed = pack_coefficients(coeffs)
    if interp == "bilinear":
        rows = gather_bilinear(packed, r, z)
    elif interp == "nearest":
        rows = gather_nearest(packed, r, z)
    else:
        raise ValueError(f"unknown interp {interp!r} (nearest|bilinear)")
    return velocity_from_rows(position, velocity, alive, rand, rows)


def velocity_from_rows(position: torch.Tensor, velocity: torch.Tensor,
                       alive: torch.Tensor, rand: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """The gather-free half of ``push_velocity``: apply pre-gathered
    R1/R2/R3/A rows (N, 12).  ``dir = (x, y) / r`` is the reference's, with
    no guard at r = 0 (fresh respawns there are re-initialized)."""
    x, y = position[..., 0], position[..., 1]
    r = torch.sqrt(x * x + y * y)
    dir_x = x / r
    dir_y = y / r
    vx, vy, vz = velocity[..., 0], velocity[..., 1], velocity[..., 2]
    vr = vx * dir_x + vy * dir_y
    va = vy * dir_x - vx * dir_y
    cyl = torch.stack([vr, va, vz], dim=-1)
    rot_r = _dot3(rows[..., 0:3], cyl) + rows[..., 9]
    rot_a = _dot3(rows[..., 3:6], cyl) + rows[..., 10]
    rot_z = _dot3(rows[..., 6:9], cyl) + rows[..., 11]
    next_v = torch.stack([rot_r * dir_x - rot_a * dir_y,
                          rot_r * dir_y + rot_a * dir_x, rot_z], dim=-1)
    thermal = 0.001 * (2.0 * rand[..., :3] - 1.0)
    return torch.where((alive > 0.5)[..., None], next_v, thermal)
