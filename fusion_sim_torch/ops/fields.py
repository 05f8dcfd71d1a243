"""Magnetic-field construction (port of ``fusion_sim_tpu/ops/fields.py``).

Each function builds a whole (nr, nz) field grid:

* ``current_loop_shape_table`` / ``current_loop_b_table`` — the two-table
  Biot-Savart scheme of ``programCurrentLoopShape`` / ``programCurrentLoop``
  (empic.js:295-389): a unit loop's field tabulated by 1000-point midpoint
  quadrature at loop radius 0.5 (near the axis) and 0.1 (far field), then
  any loop (R, Z, I) as a scaled, translated NEAREST lookup with z-mirror
  symmetry through sign(b);
* ``current_loop_b_exact`` — the closed form through complete elliptic
  integrals;
* ``line_current_b`` — axial line current, B_theta = mu0*I/(2*pi*r);
* ``uniform_bz`` / ``uniform_btheta`` — constant fields.

Fields are ``(nr, nz, 3)`` with components (B_r, B_theta, B_z) at texel
centres u = (i+0.5)/nr, v = (j+0.5)/nz of the normalized domain.  All
arithmetic is f32 in the reference's order; the quadrature is the same
1000-term sequential sum.
"""

from __future__ import annotations

import torch

from ..constants import MU_0, PI


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def grid_coords(nr: int, nz: int, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Texel-centre coordinates u = (i+0.5)/nr (nr, 1) and
    v = (j+0.5)/nz (1, nz) of the field grid in [0, 1]^2."""
    u = (torch.arange(nr, dtype=torch.float32, device=device) + 0.5) / nr
    v = (torch.arange(nz, dtype=torch.float32, device=device) + 0.5) / nz
    return u[:, None], v[None, :]


def nearest_lookup_2d(table: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """NEAREST/CLAMP sampling of a (W, H, C) table at (u, v) in [0, 1]:
    texel index clamp(floor(u*W), 0, W-1) (utilities.js:556-560)."""
    w, h = table.shape[0], table.shape[1]
    iu = torch.clamp(torch.floor(u * w).to(torch.int64), 0, w - 1)
    iv = torch.clamp(torch.floor(v * h).to(torch.int64), 0, h - 1)
    return table[iu, iv]


def current_loop_shape_table(nr: int, nz: int, loop_radius: float,
                             device=None) -> torch.Tensor:
    """The unit-current loop field over the normalized grid
    (empic.js:295-345): midpoint quadrature, 1000 azimuthal points over the
    half circle,

        constant = R * 0.001 * mu0 / (4*pi),  cos_i = cos(pi*(i+0.5)/1000)
        d_i      = sqrt(R^2 + x^2 + y^2 - 2*x*R*cos_i)
        B_x     += y * constant/d^3 * cos_i,  B_z += constant/d^3 * (R - x*cos_i)

    summed in order i = 0..999.  Returns (nr, nz, 3) = (B_r, 0, B_z) at
    (x = r, y = z) texel centres."""
    x, y = grid_coords(nr, nz, device)
    big_r = _f32(loop_radius, device)
    constant = big_r * 0.001 * MU_0 / (4.0 * PI)
    # the f32 cosines come from the CPU on every device, so the card's
    # tables equal the CPU's (the rest is correctly rounded arithmetic)
    i = torch.arange(1000, dtype=torch.float32)
    cosine = torch.cos(PI * (i + 0.5) / 1000.0)
    base = big_r * big_r + x * x + y * y
    two_xr = 2.0 * x * big_r
    bx = torch.zeros((nr, nz), dtype=torch.float32, device=device)
    bz = torch.zeros((nr, nz), dtype=torch.float32, device=device)
    for cos_i in cosine.tolist():
        d = torch.sqrt(base - two_xr * cos_i)
        factor = torch.where(d > 0.0, constant / (d * d * d), 0.0)
        bx = bx + y * factor * cos_i
        bz = bz + factor * (big_r - x * cos_i)
    return torch.stack([bx, torch.zeros_like(bx), bz], dim=-1)


def make_loop_tables(nr: int, nz: int, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two shape tables of empic.js:333-345: ``half`` (loop radius 0.5,
    lookup scale 1/2, near the axis) and ``tenth`` (radius 0.1, scale
    1/10, far away)."""
    return (current_loop_shape_table(nr, nz, 0.5, device),
            current_loop_shape_table(nr, nz, 0.1, device))


def current_loop_b_table(half: torch.Tensor, tenth: torch.Tensor,
                         loop_r, loop_z, current) -> torch.Tensor:
    """Field of a loop at normalized (loop_r, loop_z) carrying ``current``
    (empic.js:349-389): with a = r/R, b = (z-Z)/R the field is
    I * (sign(b), 1, 1) * table(a/s, |b|/s), from the tenth table (s = 10)
    where a > 2 or b > 2, else the half table (s = 2).  ``loop_r``,
    ``loop_z`` and ``current`` are rounded to f32 first, as the reference's
    shell does.  Returns (nr, nz, 3); loops accumulate by summation."""
    nr, nz = half.shape[0], half.shape[1]
    dev = half.device
    loop_r, loop_z = _f32(loop_r, dev), _f32(loop_z, dev)
    current = _f32(current, dev)
    x, y = grid_coords(nr, nz, dev)
    a = x / loop_r
    b = (y - loop_z) / loop_r
    use_tenth = (a > 2.0) | (b > 2.0)
    field_half = nearest_lookup_2d(half, a / 2.0, torch.abs(b) / 2.0)
    field_tenth = nearest_lookup_2d(tenth, a / 10.0, torch.abs(b) / 10.0)
    field = torch.where(use_tenth[..., None], field_tenth, field_half)
    ones = torch.ones_like(b)
    sign = torch.stack([torch.sign(b), ones, ones], dim=-1)
    return current * sign * field


def _ellipke(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complete elliptic integrals K(m), E(m) (m = k^2), Abramowitz &
    Stegun 17.3.34 / 17.3.36 (|error| < 2e-8), for 0 <= m < 1."""
    m1 = torch.clamp(1.0 - m, 1e-12, 1.0)
    ln = -torch.log(m1)
    ka = ((0.01451196212 * m1 + 0.03742563713) * m1
          + 0.03590092383) * m1 + 0.09666344259
    ka = ka * m1 + 1.38629436112
    kb = ((0.00441787012 * m1 + 0.03328355346) * m1
          + 0.06880248576) * m1 + 0.12498593597
    kb = kb * m1 + 0.5
    big_k = ka + kb * ln
    ea = ((0.01736506451 * m1 + 0.04757383546) * m1
          + 0.0626060122) * m1 + 0.44325141463
    ea = ea * m1 + 1.0
    eb = ((0.00526449639 * m1 + 0.04069697526) * m1
          + 0.09200180037) * m1 + 0.2499836831
    eb = eb * m1
    big_e = ea + eb * ln
    return big_k, big_e


def current_loop_b_exact(r: torch.Tensor, z: torch.Tensor, loop_r, loop_z,
                         current) -> torch.Tensor:
    """Physical (B_r, 0, B_z) of a circular loop of radius ``loop_r`` at
    height ``loop_z`` carrying ``current`` amps, at cylindrical (r, z) in
    metres: the elliptic-integral closed form, with the on-axis limit
    B_z = mu0*I*R^2 / (2*(R^2+z^2)^{3/2}).  Scalars are rounded to f32."""
    dev = r.device
    loop_r, loop_z = _f32(loop_r, dev), _f32(loop_z, dev)
    current = _f32(current, dev)
    dz = z - loop_z
    rho = torch.clamp(r, min=0.0)
    dz2 = dz * dz
    denom = (loop_r + rho) ** 2 + dz2
    inv_denom = 1.0 / denom
    m = (4.0 * loop_r) * rho * inv_denom
    big_k, big_e = _ellipke(m)
    inv_alpha2 = 1.0 / ((loop_r - rho) ** 2 + dz2)
    pref = (MU_0 / (2.0 * PI)) * current * torch.rsqrt(denom)
    inv_rho = 1.0 / torch.where(rho > 1e-9 * loop_r, rho, 1.0)
    r2 = loop_r * loop_r
    rho2 = rho * rho
    br = pref * (dz * inv_rho) * ((r2 + rho2 + dz2) * inv_alpha2 * big_e
                                  - big_k)
    bz = pref * (big_k + (r2 - rho2 - dz2) * inv_alpha2 * big_e)
    ax = r2 + dz2
    on_axis_bz = (0.5 * MU_0) * current * r2 * torch.rsqrt(ax) / ax
    on_axis = rho <= 1e-9 * loop_r
    br = torch.where(on_axis, 0.0, br)
    bz = torch.where(on_axis, on_axis_bz, bz)
    return torch.stack([br, torch.zeros_like(br), bz], dim=-1)


def line_current_b(nr: int, nz: int, current, device=None) -> torch.Tensor:
    """Axial line current, B_theta = mu0*I/(2*pi*r) on the normalized grid
    (empic.js:392-414)."""
    x, _ = grid_coords(nr, nz, device)
    btheta = _f32(current, device) * MU_0 / (2.0 * PI * x)
    btheta = torch.broadcast_to(btheta, (nr, nz))
    zeros = torch.zeros((nr, nz), dtype=torch.float32, device=device)
    return torch.stack([zeros, btheta, zeros], dim=-1)


def uniform_bz(nr: int, nz: int, bz, device=None) -> torch.Tensor:
    """Uniform axial field (``programBZ``, empic.js:417-439)."""
    field = torch.zeros((nr, nz, 3), dtype=torch.float32, device=device)
    field[..., 2] = _f32(bz, device)
    return field


def uniform_btheta(nr: int, nz: int, btheta, device=None) -> torch.Tensor:
    """Uniform azimuthal field (``programBTheta``, empic.js:442-464)."""
    field = torch.zeros((nr, nz, 3), dtype=torch.float32, device=device)
    field[..., 1] = _f32(btheta, device)
    return field
