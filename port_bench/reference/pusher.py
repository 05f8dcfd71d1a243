"""Plain PyTorch reference of one frame of the fusion-sim browser app: the
cylindrical test-particle pusher between current loops
(``makeCylindricalParticlePusher``, empic.js:30-1529) as its frame loop
runs it, ``step()`` then ``density()`` (fusionsim.js:170-202).

Written from the app's description and nothing else, in plain ``torch``
operations; it imports neither JAX nor the port.  State is the app's:
positions and velocities Cartesian, scaled per axis by (1/radius,
1/radius, 1/height), velocities in units of c; ``alive`` is the
position's w flag.  ``fdtype`` is the precision of every grid, field and
velocity (float32 the reference, bfloat16 the lower-precision control);
positions stay float32, and the fields are built in float64.  TF32 is
off.

- Fields (empic.js:295-389): each loop's B is the app's two-table
  lookup, a unit loop of radius 0.5 (near) or 0.1 (far) tabulated on the
  grid's texel centres and read NEAREST at (a/s, |b|/s), a = r/R, b =
  (z - Z)/R, times I (sign(b), 1, 1).  The tables are the app's
  1000-point midpoint Biot-Savart sum over the half loop, here in
  float64; the texel each cell reads is picked in float32, as the app's
  shader picks it.
- Coefficients (``precalc``, empic.js:506-659): the Boris rows R1, R2, R3
  with the metric factors on the z couplings, computed in float64 from
  B; E is zero in every configuration here, so A is zero.
- A half-step (empic.js:692-773): the coefficients of the nearest
  (clamped) cell, the rotation in the local (r, theta, z) frame, or for
  rows with alive <= 0.5 the thermal re-init 0.001 (2u - 1) from the
  substep's first three uniforms; the drift x + dt c v; the sink of the
  drifted cell, nearest; an absorbed row respawns at (r', 0, z') from an
  inverse-CDF table of the source (empic.js:1268-1341), read NEAREST with
  the substep's first two uniforms, with alive = 0.  A frame is two
  half-steps.
- ``density`` (empic.js:1471-1505): each row splats 0.001 (v_r, v_theta,
  v_z, 1) with the 11 x 11 cos^2 bell (sum 1) centred on its nearest
  cell, the moments are normalized (rgb / a, a) x 1000 x 0.5 / u (u the
  texel-centre r), averaged into the EMA at ratio 0.01, and the frame is
  the |B| layer (red |B| |min(0, dir_z)|, green |B| dir_r, blue |B|
  max(0, dir_z)) plus 0.25 a.

Departures from the app:

- the sampled B: the tables' sums run in float64 where the app's run in
  float32.  Where the rows move, B agrees with the app's to float32
  rounding (h |dB| < 1e-6 on 400 x 800); beside a loop's wire the app's
  float32 loses R^2 + x^2 + y^2 - 2 x R cos(phi) to cancellation, and
  its |B| there is off by up to 2% of the largest |B| (the cell beside
  the wire) and 1.6e-4 sixteen cells away.  So the frame, whose |B| layer
  carries that, is compared through its change over a frame, in which
  the layer cancels (``frame_change``); the texel picks are the app's;
- the uniform stream: the app draws its uniforms from a chaotic-map
  generator on the GPU (empic.js:783-895); the reference is handed the
  program's own uniforms, four a row a half-step, and draws none;
- a row at r = 0 (a respawn at the source's inner edge) takes the
  direction of the theta = 0 half-plane, (1, 0), where the app divides
  0 by 0;
- the inverse CDF at a quantile of 0 takes its limit from above (the
  first cell with mass), where the app divides 0 by 0;
- the splat is a per-row stencil at the nearest cell, where the app
  rasterizes an 11-pixel point sprite (the same pixels and weights).
"""

from __future__ import annotations

import math

import torch

# the app's constants (empic.js:27, 314)
SPEED_OF_LIGHT = 2.998e8
MU_0 = 1.25663706e-6
PI = 3.14159265359
QUADRATURE = 1000       # midpoints over the half loop (empic.js:305)
INV_CDF_SIZE = 512      # the respawn table's side (empic.js:228-241)
BELL = 11               # the splat's side (empic.js:949)
EMA_RATIO = 0.01        # empic.js:1083
ROWS = 1 << 20          # rows per block of the particle passes
TERMS = 50              # quadrature terms per block

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def texel_centres(nr: int, nz: int, dtype, device):
    """(i + 0.5) / nr as (nr, 1) and (j + 0.5) / nz as (1, nz)."""
    u = (torch.arange(nr, dtype=dtype, device=device) + 0.5) / nr
    v = (torch.arange(nz, dtype=dtype, device=device) + 0.5) / nz
    return u[:, None], v[None, :]


def unit_loop_table(nr: int, nz: int, loop_radius: float, device
                    ) -> torch.Tensor:
    """The app's unit-current loop table (empic.js:295-345) in float64:
    at texel centres (x, y), with constant = R 0.001 mu0 / (4 pi),
    c_i = cos(pi (i + 0.5) / 1000) and d_i = sqrt(R^2 + x^2 + y^2 -
    2 x R c_i), B_r = sum y constant c_i / d_i^3 and B_z = sum constant
    (R - x c_i) / d_i^3.  (nr, nz, 3) as (B_r, 0, B_z)."""
    f64 = torch.float64
    x, y = texel_centres(nr, nz, f64, device)
    big_r = float(loop_radius)
    constant = big_r * 0.001 * MU_0 / (4.0 * PI)
    cosines = torch.cos(PI * (torch.arange(QUADRATURE, dtype=f64,
                                           device=device) + 0.5) / QUADRATURE)
    base = (big_r * big_r + x * x + y * y)[..., None]
    two_xr = (2.0 * big_r * x)[..., None]
    br = torch.zeros((nr, nz), dtype=f64, device=device)
    bz = torch.zeros((nr, nz), dtype=f64, device=device)
    for lo in range(0, QUADRATURE, TERMS):
        c = cosines[lo:lo + TERMS]
        d = torch.sqrt(base - two_xr * c)
        factor = torch.where(d > 0, constant / (d * d * d), 0.0)
        br = br + (y[..., None] * factor * c).sum(-1)
        bz = bz + (factor * (big_r - x[..., None] * c)).sum(-1)
    return torch.stack([br, torch.zeros_like(br), bz], dim=-1)


def _nearest(table: torch.Tensor, u: torch.Tensor, v: torch.Tensor
             ) -> torch.Tensor:
    """NEAREST/CLAMP read of a (W, H, C) table at float32 (u, v)."""
    w, h = table.shape[0], table.shape[1]
    iu = torch.clamp(torch.floor(u * w).to(torch.int64), 0, w - 1)
    iv = torch.clamp(torch.floor(v * h).to(torch.int64), 0, h - 1)
    return table[iu, iv]


def loops_b(phys: dict, device) -> torch.Tensor:
    """B (nr, nz, 3) in float64, (B_r, B_theta, B_z) in tesla, of the
    configuration's loops (empic.js:349-389): per loop at normalized
    (R, Z) = (r / radius, z / height) with current I (each rounded to
    float32, as the app holds them), a = x / R and b = (y - Z) / R at the
    texel centres in float32; the far table where a > 2 or b > 2."""
    nr, nz = phys["grid_shape"]
    half = unit_loop_table(nr, nz, 0.5, device)
    tenth = unit_loop_table(nr, nz, 0.1, device)
    x, y = texel_centres(nr, nz, torch.float32, device)
    b_total = torch.zeros((nr, nz, 3), dtype=torch.float64, device=device)
    for r_m, z_m, current in phys["coils"]:
        big_r = _f32(r_m * (1.0 / phys["radius"])).to(device)
        big_z = _f32(z_m * (1.0 / phys["height"])).to(device)
        a = x / big_r
        b = (y - big_z) / big_r
        far = ((a > 2.0) | (b > 2.0))[..., None]
        field = torch.where(far, _nearest(tenth, a / 10.0, b.abs() / 10.0),
                            _nearest(half, a / 2.0, b.abs() / 2.0))
        sign = torch.stack([torch.sign(b), torch.ones_like(b),
                            torch.ones_like(b)], dim=-1).to(torch.float64)
        b_total = b_total + float(_f32(current)) * sign * field
    return b_total


def coefficients(phys: dict, b: torch.Tensor, fdtype: torch.dtype
                 ) -> torch.Tensor:
    """The (nr, nz, 9) rows R1 | R2 | R3 of the app's Boris rotation
    (empic.js:506-659) from B in float64, with h = q dt / (2 m):
    hB2 = h^2 |B|^2, f = 2 / (1 + hB2), R_ii = 1 - hB2 f + f h^2 B_i^2,
    R_ij = f h (+-B_k + h B_i B_j); the z couplings of rows 1 and 2 times
    radius / height, those of row 3 times height / radius."""
    h = phys["particle_charge"] * phys["dt"] / (2.0 * phys["particle_mass"])
    rz = phys["height"] / phys["radius"]        # factor_r / factor_z
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    hb2 = h * h * (bx * bx + by * by + bz * bz)
    f = 2.0 / (1.0 + hb2)
    diag = 1.0 - hb2 * f
    rows = [diag + f * h * h * bx * bx, f * h * (bz + h * bx * by),
            f * h * (-by + h * bx * bz) * rz,
            f * h * (-bz + h * by * bx), diag + f * h * h * by * by,
            f * h * (bx + h * by * bz) * rz,
            f * h * (by + h * bz * bx) / rz, f * h * (-bx + h * bz * by) / rz,
            diag + f * h * h * bz * bz]
    return torch.stack(rows, dim=-1).to(fdtype)


def sink_mask(phys: dict, device) -> torch.Tensor:
    """The app's wall sinks (fusionsim.js:94-112): 0 (absorb) in the last
    r-cell at every z and in the first and last z-cells of r-cells 1 to
    nr - 2; the on-axis column of the z walls is open."""
    nr, nz = phys["grid_shape"]
    if phys["sinks"] != "walls":
        raise ValueError(f"sinks {phys['sinks']!r}: only 'walls'")
    keep = torch.ones((nr, nz), dtype=torch.float32, device=device)
    keep[-1, :] = 0.0
    keep[1:-1, 0] = 0.0
    keep[1:-1, -1] = 0.0
    return keep


def source_pdf(phys: dict, device) -> torch.Tensor:
    """The app's box source (fusionsim.js:114-122): 1 on the r-cells
    [0, max(1, floor(r1 nr))) and z-cells [floor(z0 nz), floor(z1 nz)) of
    ``source_box`` = (0, r1, z0, z1) as shares of the grid, else 0."""
    nr, nz = phys["grid_shape"]
    r0, r1, z0, z1 = phys["source_box"]
    pdf = torch.zeros((nr, nz), dtype=torch.float64, device=device)
    pdf[math.floor(r0 * nr):max(1, math.floor(r1 * nr)),
        math.floor(z0 * nz):math.floor(z1 * nz)] = 1.0
    return pdf


def _inverse(cdf: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The app's inverse of a discrete CDF (empic.js:1296-1311): with i
    the first index where cdf >= f, (i + (f - cdf[i-1]) / (cdf[i] -
    cdf[i-1])) / n; at f = 0 its limit from above, the first index with
    mass over n.  ``cdf`` (..., n) ascending, ``f`` (..., m) with the same
    leading axes."""
    n = cdf.shape[-1]
    i = torch.searchsorted(cdf, torch.where(f > 0, f, 0.0), side="left")
    first = torch.searchsorted(cdf, torch.zeros_like(f), side="right")
    i = torch.clamp(torch.where(f > 0, i, first), max=n - 1)
    prev = torch.where(i > 0, torch.gather(cdf, -1, torch.clamp(i - 1, min=0)),
                       0.0)
    denom = torch.gather(cdf, -1, i) - prev
    frac = torch.where((denom > 0) & (f > 0), (f - prev) / denom, 0.0)
    return (i.to(cdf.dtype) + frac) / n


def inverse_cdf_table(pdf: torch.Tensor) -> torch.Tensor:
    """The (512, 512, 2) respawn table (empic.js:1268-1341) in float64:
    entry [i, j] = (r, z) normalized for the quantiles f1 = i / 511 of the
    r marginal and f2 = j / 511 of the z conditional of row int(r nr)
    (stepped back onto the last row with mass at the top quantile)."""
    nr, nz = pdf.shape
    row_sums = pdf.sum(1)
    cdf_r = torch.cumsum(row_sums, 0) / row_sums.sum()
    ramp = (torch.arange(nz, dtype=pdf.dtype, device=pdf.device) + 1) / nz
    cdf_z = torch.where(row_sums[:, None] > 0,
                        torch.cumsum(pdf, 1)
                        / torch.where(row_sums > 0, row_sums, 1.0)[:, None],
                        ramp)
    f = torch.arange(INV_CDF_SIZE, dtype=pdf.dtype,
                     device=pdf.device) / (INV_CDF_SIZE - 1)
    r = _inverse(cdf_r, f)
    rows = torch.clamp((r * nr).to(torch.int64), max=nr - 1)
    rows = torch.where(row_sums[rows] > 0, rows, torch.clamp(rows - 1, min=0))
    z = _inverse(cdf_z[rows], f.expand(INV_CDF_SIZE, -1).contiguous())
    return torch.stack([r[:, None].expand(-1, INV_CDF_SIZE), z], dim=-1)


def bell(device) -> torch.Tensor:
    """The 11 x 11 cos^2 radial bell (empic.js:956-971), sum 1, float64."""
    mid = (BELL - 1) / 2
    k = torch.arange(BELL, dtype=torch.float64, device=device)
    d = torch.sqrt((k[:, None] - mid) ** 2 + (k[None, :] - mid) ** 2)
    w = torch.clamp(torch.cos(0.5 * math.pi * d / mid), min=0.0) ** 2
    return w / w.sum()


class Fields:
    """What a frame reads of the configuration."""

    def __init__(self, phys: dict, device):
        self.phys = phys
        self.b = loops_b(phys, device)
        self.sink = sink_mask(phys, device)
        self.table = inverse_cdf_table(source_pdf(phys, device)).float()
        self.bell = bell(device)


def _cells(pos: torch.Tensor, nr: int, nz: int):
    """The nearest (clamped) cell of float32 normalized positions, and r."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    r = torch.sqrt(x * x + y * y)
    ir = torch.clamp(torch.floor(r * nr).to(torch.int64), 0, nr - 1)
    iz = torch.clamp(torch.floor(z * nz).to(torch.int64), 0, nz - 1)
    return ir, iz, r


def _direction(pos: torch.Tensor, r: torch.Tensor):
    on_axis = r == 0.0
    return (torch.where(on_axis, 1.0, pos[:, 0] / r),
            torch.where(on_axis, 0.0, pos[:, 1] / r))


def half_step(F: Fields, coef: torch.Tensor, pos: torch.Tensor,
              vel: torch.Tensor, alive: torch.Tensor, rand: torch.Tensor,
              fdtype: torch.dtype):
    """One half-step of rows ``(pos f32, vel fdtype, alive)`` with this
    half-step's (N, 4) uniforms; returns ``(pos, vel, alive, absorbed)``."""
    phys = F.phys
    nr, nz = phys["grid_shape"]
    step_factor = phys["dt"] * SPEED_OF_LIGHT
    ir, iz, r = _cells(pos, nr, nz)
    c = coef[ir, iz]
    dx, dy = (d.to(fdtype) for d in _direction(pos, r))
    vr = vel[:, 0] * dx + vel[:, 1] * dy
    va = vel[:, 1] * dx - vel[:, 0] * dy
    vz = vel[:, 2]
    rot_r = c[:, 0] * vr + c[:, 1] * va + c[:, 2] * vz
    rot_a = c[:, 3] * vr + c[:, 4] * va + c[:, 5] * vz
    rot_z = c[:, 6] * vr + c[:, 7] * va + c[:, 8] * vz
    rotated = torch.stack([rot_r * dx - rot_a * dy, rot_r * dy + rot_a * dx,
                           rot_z], dim=-1)
    thermal = (0.001 * (2.0 * rand[:, :3] - 1.0)).to(fdtype)
    vel = torch.where((alive > 0.5)[:, None], rotated, thermal)
    pos = pos + step_factor * vel.float()
    sr, sz, _ = _cells(pos, nr, nz)
    absorbed = F.sink[sr, sz] <= 0.5
    size = F.table.shape[0]
    iu = torch.clamp(torch.floor(rand[:, 0] * size).to(torch.int64), 0,
                     size - 1)
    iv = torch.clamp(torch.floor(rand[:, 1] * size).to(torch.int64), 0,
                     size - 1)
    fresh = F.table[iu, iv]
    fresh = torch.stack([fresh[:, 0], torch.zeros_like(fresh[:, 0]),
                         fresh[:, 1]], dim=-1)
    pos = torch.where(absorbed[:, None], fresh, pos)
    return pos, vel, (~absorbed).to(torch.float32), absorbed


def moments(F: Fields, pos: torch.Tensor, vel: torch.Tensor,
            fdtype: torch.dtype) -> torch.Tensor:
    """The (nr, nz, 4) moment splat of the rows, in ``fdtype``."""
    nr, nz = F.phys["grid_shape"]
    grid = torch.zeros(((nr + BELL) * (nz + BELL), 4), dtype=fdtype,
                       device=pos.device)
    pad = BELL // 2
    w = F.bell.to(fdtype)
    for lo in range(0, pos.shape[0], ROWS):
        p, v = pos[lo:lo + ROWS], vel[lo:lo + ROWS]
        ir, iz, r = _cells(p, nr, nz)
        dx, dy = (d.to(fdtype) for d in _direction(p, r))
        color = 0.001 * torch.stack([v[:, 0] * dx + v[:, 1] * dy,
                                     v[:, 1] * dx - v[:, 0] * dy, v[:, 2],
                                     torch.ones_like(dx)], dim=-1)
        # the stencil lands in a grid padded by its half-width on each side
        for i in range(BELL):
            for j in range(BELL):
                flat = (ir + i) * (nz + BELL) + iz + j
                grid.index_add_(0, flat, w[i, j] * color)
    grid = grid.reshape(nr + BELL, nz + BELL, 4)
    return grid[pad:pad + nr, pad:pad + nz]


def bmag_layer(b: torch.Tensor) -> torch.Tensor:
    """The frame's |B| layer (empic.js:467-493) of B (nr, nz, 3)."""
    mag = torch.sqrt((b * b).sum(-1))
    safe = torch.where(mag > 0, mag, 1.0)
    dir_z = torch.where(mag > 0, b[..., 2] / safe, 0.0)
    dir_r = torch.where(mag > 0, b[..., 0] / safe, 0.0)
    return torch.stack([mag * dir_z.clamp(max=0.0).abs(), mag * dir_r,
                        mag * dir_z.clamp(min=0.0)], dim=-1)


def density(F: Fields, pos: torch.Tensor, vel: torch.Tensor,
            avg: torch.Tensor, fdtype: torch.dtype):
    """After the app's ``density()``, in ``fdtype``: the EMA, the frame,
    the frame's change from the frame of the EMA before (the |B| layer
    cancels) and this frame's count channel."""
    nr = F.phys["grid_shape"][0]
    m = moments(F, pos, vel, fdtype)
    a = m[..., 3:4]
    norm = torch.where(a > 0, torch.cat([m[..., :3] / torch.where(
        a > 0, a, 1.0), a], dim=-1), 0.0)
    u = ((torch.arange(nr, dtype=torch.float64, device=pos.device) + 0.5)
         / nr).to(fdtype)[:, None, None]
    norm = 1000.0 * norm * 0.5 / u
    old = avg.to(fdtype)
    avg = EMA_RATIO * norm + (1.0 - EMA_RATIO) * old
    layer = bmag_layer(F.b).to(fdtype)
    frame = layer + 0.25 * avg[..., 3:4]
    return avg, frame, frame - (layer + 0.25 * old[..., 3:4]), m[..., 3]


def frame(phys: dict, pos: torch.Tensor, vel: torch.Tensor,
          alive: torch.Tensor, avg: torch.Tensor, rands: torch.Tensor,
          fdtype: torch.dtype = torch.float32) -> dict:
    """One app frame of the rows ``pos``, ``vel`` (N, 3) normalized,
    ``alive`` (N,), from the EMA ``avg`` (nr, nz, 4), with the frame's
    uniforms ``rands`` (2, N, 4): two half-steps, then ``density()``.
    Returns float32 ``pos``, ``vel``, ``alive``, ``avg``, ``frame``, the
    frame's change ``frame_change``, this frame's count channel ``count``
    (before normalization) and ``survived`` (alive at the start and
    absorbed in neither half)."""
    F = Fields(phys, pos.device)
    coef = coefficients(phys, F.b, fdtype)
    pos = pos.float()
    vel = vel.to(fdtype)
    survived = alive > 0.5
    for rand in rands:
        pos, vel, alive, absorbed = half_step(F, coef, pos, vel, alive,
                                              rand.float(), fdtype)
        survived = survived & ~absorbed
    avg, image, change, count = density(F, pos, vel, avg, fdtype)
    return {"pos": pos, "vel": vel.float(), "alive": alive,
            "avg": avg.float(), "frame": image.float(),
            "frame_change": change.float(), "count": count.float(),
            "survived": survived}
