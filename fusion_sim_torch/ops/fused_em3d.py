"""Fused 3D EM-PIC substep: gather + Boris kick + drift + Esirkepov deposit
in one kernel (3D3V, tile-sorted layout).

Port of ``fusion_sim_tpu/ops/pallas_em3d.py : fused_em3d_substep`` (kernel
B6 of the port), the 3D form of ops/fused_em.py.  Per row of the padded
tile-sorted layout, in the block's window-local frame (l = mod(x - origin,
n) per axis, origin = the block's tile corner minus the margin):

    E, B = CIC-gather(table, l0)      6 channels, 8 corners of the node table
    u'   = Boris(u, E, B)             optionally relativistic (u = gamma v)
    l1   = l0 + dt v' / dx            drift (v' = u'/gamma' if relativistic)
    J   += Esirkepov(q, l0 -> l1)     3 components, charge conserving

then back to global periodic coordinates.  A row whose l0 (gather) or l1
(deposit) leaves ``[0, w - 1)`` on any axis comes back frozen (position
mod(l0 + origin, n), velocity as given) with no deposit and ``in_win =
False``; the model re-pushes it exactly from its input (its spill patch).
An invalid row carries no charge but is pushed like any other (the model
zeroes fillers afterwards).  Rows of blocks carrying the sentinel tile id
(``n_tiles``, the layout's trailing dead blocks) have no window: they come
back exactly as given, ``in_win = False``, no deposit.

The Esirkepov factors are the reference kernel's, node by node of the
window: tents ``S(l)[i] = max(0, 1 - |l - i|)``, dS = S(l1) - S(l0), and
the closed-form cumulative tent ``K[i] = clip(i - l1 + 1, 0, 1) -
clip(i - l0 + 1, 0, 1)``; with c_a = -d_a/(V dt):

    Jx[i, j, k] += (q cx Kx[i]) [(S0y[j] + dSy[j]/2) S0z[k]
                                 + (S0y[j]/2 + dSy[j]/3) dSz[k]]
    Jy[i, j, k] += (S0x[i] + dSx[i]/2) (q cy Ky[j]) S0z[k]
                   + (S0x[i]/2 + dSx[i]/3) (q cy Ky[j]) dSz[k]
    Jz[i, j, k] += (S0x[i] + dSx[i]/2) (q cz Kz[k]) S0y[j]
                   + (S0x[i]/2 + dSx[i]/3) (q cz Kz[k]) dSy[j]

Only the nodes floor(min(l0, l1)) .. floor(max(l0, l1)) + 1 of each axis
are nonzero (2 or 3 of them while the drift stays under a cell; more for a
faster row, which the window form covers too).

On a CUDA tensor ``fused_em3d_substep`` launches the hand-written kernel
``csrc/em3d_substep.cu`` (counted in ``LAUNCHES``), one CTA a tile, which
needs the layout's blocks sorted by tile id as ``build_padded_layout`` and
the repair keep them, or raises; on a CPU
tensor it runs ``fused_em3d_substep_plain``, the same function in plain
PyTorch, which the tests hold against the JAX kernel and the card holds
the kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .fused_em import _cum_tent, _tent
from .fused_pic import _check
from .fused_pic3d import (SHARED_MEMORY_LIMIT, corner_cells_3d,
                          local_frame_3d)
from .precision import resolve_precision

LAUNCHES = 0  # kernel launches by fused_em3d_substep (CUDA tensors only)


def _constants(shape, tiling, position, qm_half_dt, dt, cell_size, charge,
               c_light):
    """Layout sizes and the scalars the kernel takes, rounded on the host
    as the reference rounds them (1/dx, -dx/(V dt), 1/c^2)."""
    nts = tiling.n_tiles(shape)
    if position.shape[0] % tiling.block:
        raise ValueError(f"N={position.shape[0]} not a multiple of "
                         f"block={tiling.block}")
    dx, dy, dz = cell_size
    vol = dx * dy * dz
    scalars = dict(qm_half_dt=float(qm_half_dt), dt=float(dt),
                   inv_dx=float(1.0 / dx), inv_dy=float(1.0 / dy),
                   inv_dz=float(1.0 / dz), coef_x=float(-dx / (vol * dt)),
                   coef_y=float(-dy / (vol * dt)),
                   coef_z=float(-dz / (vol * dt)),
                   inv_c2=float(1.0 / (c_light * c_light)),
                   charge=float(charge))
    if not all(math.isfinite(x) for x in scalars.values()):
        raise ValueError(f"non-finite substep constant in {scalars}")
    return nts, math.prod(nts), scalars


def fused_em3d_substep_plain(table, position, velocity, valid, tile_id,
                             shape, tiling, qm_half_dt, dt, cell_size,
                             charge, c_light: float = 1.0,
                             relativistic: bool = False):
    """The substep in plain PyTorch, with the kernel's operation order.

    Arguments and returns as ``fused_em3d_substep``.  The gather reads the
    table at the window cell's global (wrapped) index, which is the value
    the window holds, and the deposit adds into the grid at the wrapped
    index of the window node.  The deposit loops over the span of nodes a
    row touches, so memory stays at rows x stencil, not rows x window."""
    _, n_tiles, k = _constants(shape, tiling, position, qm_half_dt, dt,
                               cell_size, charge, c_light)
    nx, ny, nz = shape
    wins = tiling.window()
    h = k["qm_half_dt"]
    real_tile, o_i, o_f, l0 = local_frame_3d(position, tile_id, shape,
                                             tiling, n_tiles)
    vx, vy, vz = velocity[:, 0], velocity[:, 1], velocity[:, 2]
    g_inw = (real_tile & (l0[0] < wins[0] - 1) & (l0[1] < wins[1] - 1)
             & (l0[2] < wins[2] - 1))

    # 6-channel CIC gather: the (y, z) pair first, then x
    f, g0, g1 = corner_cells_3d(l0, o_i, shape)
    a0 = [(1.0 - (l0[a] - f[a]))[:, None] for a in range(3)]
    a1 = [(1.0 - ((f[a] + 1.0) - l0[a]))[:, None] for a in range(3)]
    flat = table.reshape(nx * ny * nz, 6)
    eb = 0.0
    for gx, wx in ((g0[0], a0[0]), (g1[0], a1[0])):
        r0, r1 = (gx * ny + g0[1]) * nz, (gx * ny + g1[1]) * nz
        plane = ((a0[1] * a0[2]) * flat[r0 + g0[2]]
                 + (a0[1] * a1[2]) * flat[r0 + g1[2]]
                 + (a1[1] * a0[2]) * flat[r1 + g0[2]]
                 + (a1[1] * a1[2]) * flat[r1 + g1[2]])
        eb = eb + wx * plane
    ex, ey, ez, bx, by, bz = eb.unbind(-1)

    # Boris kick (models/electromagnetic.boris_kick, component by component)
    vmx, vmy, vmz = vx + h * ex, vy + h * ey, vz + h * ez
    tx, ty, tz = h * bx, h * by, h * bz
    if relativistic:
        gamma = torch.sqrt(1.0 + (vmx * vmx + vmy * vmy + vmz * vmz)
                           * k["inv_c2"])
        tx, ty, tz = tx / gamma, ty / gamma, tz / gamma
    sfac = 2.0 / (1.0 + (tx * tx + ty * ty + tz * tz))
    sx, sy, sz = tx * sfac, ty * sfac, tz * sfac
    vpx = vmx + (vmy * tz - vmz * ty)
    vpy = vmy + (vmz * tx - vmx * tz)
    vpz = vmz + (vmx * ty - vmy * tx)
    nv = [vmx + (vpy * sz - vpz * sy) + h * ex,
          vmy + (vpz * sx - vpx * sz) + h * ey,
          vmz + (vpx * sy - vpy * sx) + h * ez]

    # drift (coordinate velocity = u/gamma when relativistic)
    if relativistic:
        gamma1 = torch.sqrt(1.0 + (nv[0] * nv[0] + nv[1] * nv[1]
                                   + nv[2] * nv[2]) * k["inv_c2"])
        cv = [u / gamma1 for u in nv]
    else:
        cv = nv
    inv_d = (k["inv_dx"], k["inv_dy"], k["inv_dz"])
    l1 = [l0[a] + k["dt"] * cv[a] * inv_d[a] for a in range(3)]
    inw = g_inw
    for a in range(3):
        inw = inw & (l1[a] >= 0.0) & (l1[a] < wins[a] - 1)

    # Esirkepov deposit of the in-window charged rows, node by node
    j = torch.zeros((nx * ny * nz, 3), dtype=torch.float32,
                    device=position.device)
    dep = inw & valid
    if bool(dep.any()):
        q = torch.full_like(l0[0][dep], k["charge"])
        coefs = (k["coef_x"], k["coef_y"], k["coef_z"])

        def factors(a):
            """Per node of axis a's span: (grid index, in span, q c K, S0,
            dS)."""
            p0, p1 = l0[a][dep], l1[a][dep]
            base = torch.floor(torch.minimum(p0, p1))
            span = torch.floor(torch.maximum(p0, p1)) + 1.0 - base
            qc = q * coefs[a]
            out = []
            for step in range(int(span.max()) + 1):
                node = base + float(step)
                s0 = _tent(p0, node)
                out.append((torch.remainder(o_i[a][dep] + node.to(torch.int64),
                                            shape[a]),
                            (step <= span) & (node < wins[a]),
                            qc * _cum_tent(p0, p1, node), s0,
                            _tent(p1, node) - s0))
            return out

        y_factors, z_factors = factors(1), factors(2)
        for gi, ok_x, kxq, s0x, dsx in factors(0):
            p1x, p2x = s0x + 0.5 * dsx, 0.5 * s0x + dsx / 3.0
            for gj, ok_y, kyq, s0y, dsy in y_factors:
                m1y, m2y = s0y + 0.5 * dsy, 0.5 * s0y + dsy / 3.0
                ok_xy = ok_x & ok_y
                row = (gi * ny + gj) * nz
                for gk, ok_z, kzq, s0z, dsz in z_factors:
                    vals = torch.stack([
                        kxq * (m1y * s0z + m2y * dsz),
                        p1x * (kyq * s0z) + p2x * (kyq * dsz),
                        p1x * (kzq * s0y) + p2x * (kzq * dsy)], dim=-1)
                    ok = ok_xy & ok_z
                    j.index_add_(0, (row + gk)[ok], vals[ok])

    pos_out = torch.stack([
        torch.where(real_tile, torch.remainder(
            torch.where(inw, l1[a], l0[a]) + o_f[a], float(shape[a])),
            position[:, a]) for a in range(3)], dim=-1)
    vel_out = torch.stack([torch.where(inw, nv[a], velocity[:, a])
                           for a in range(3)], dim=-1)
    return pos_out, vel_out, j.reshape(nx, ny, nz, 3), inw


def _library():
    from . import _build

    lib = _build.load("em3d_substep")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.em3d_substep.argtypes = [p] * 9 + [i] * 13 + [f] * 10 + [p]
        lib.em3d_substep.restype = i
        lib.em3d_substep_smem.argtypes = [i] * 3
        lib.em3d_substep_smem.restype = ctypes.c_longlong
        lib.em3d_error_string.argtypes = [i]
        lib.em3d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(table, position, velocity, valid, tile_id, shape, tiling,
            relativistic, nts, n_tiles, k):
    global LAUNCHES
    nx, ny, nz = shape
    n = position.shape[0]
    dev = position.device
    f32 = torch.float32
    # the table is read as float2: 8-byte aligned
    _check("table", table, f32, (nx, ny, nz, 6), dev, align=8)
    _check("position", position, f32, (n, 3), dev)
    _check("velocity", velocity, f32, (n, 3), dev)
    _check("valid", valid, torch.bool, (n,), dev, align=1)
    _check("tile_id", tile_id, torch.int32, (n,), dev)
    if n >= 2 ** 31 or nx * ny * nz >= 2 ** 31 // 6:
        raise ValueError("the kernel counts rows and grid values with "
                         "32-bit ints")
    lib = _library()
    # the current window (and the field window beside it where it fits)
    smem = lib.em3d_substep_smem(*tiling.window())
    if smem > SHARED_MEMORY_LIMIT:
        raise ValueError(
            f"a {tiling.window()} window needs {smem} B of shared memory "
            f"for its current, above "
            f"the {SHARED_MEMORY_LIMIT} B a block can use: take smaller "
            f"tiles or a smaller margin")
    pos_out = torch.empty_like(position)
    vel_out = torch.empty_like(velocity)
    j = torch.zeros((nx, ny, nz, 3), dtype=f32, device=dev)
    in_win = torch.empty((n,), dtype=torch.bool, device=dev)
    err = lib.em3d_substep(
        table.data_ptr(), position.data_ptr(), velocity.data_ptr(),
        valid.data_ptr(), tile_id.data_ptr(), pos_out.data_ptr(),
        vel_out.data_ptr(), j.data_ptr(), in_win.data_ptr(),
        n, tiling.block, nx, ny, nz,
        nts[1], nts[2], n_tiles, *tiling.tile, tiling.margin,
        int(bool(relativistic)),
        k["qm_half_dt"], k["dt"], k["inv_dx"], k["inv_dy"], k["inv_dz"],
        k["coef_x"], k["coef_y"], k["coef_z"], k["inv_c2"], k["charge"],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("em3d_substep launch failed: "
                           + lib.em3d_error_string(err).decode())
    LAUNCHES += 1
    return pos_out, vel_out, j, in_win


def fused_em3d_substep(table, position, velocity, valid, tile_id, shape,
                       tiling, qm_half_dt: float, dt: float,
                       cell_size: tuple[float, float, float], charge: float,
                       c_light: float = 1.0, relativistic: bool = False,
                       precision: str = "highest"):
    """One fused EM particle substep for the tile-sorted 3D3V layout.

    ``table``: the (nx, ny, nz, 6) f32 node-centered E|B table
    (ops/fdtd.center_fields); ``position`` and ``velocity`` (N, 3) f32 in
    the padded sorted layout (N = nb * tiling.block), ``valid`` (N,) bool
    (fillers carry no charge), ``tile_id`` (N,) int32.  Returns
    ``(position', velocity', j (nx, ny, nz, 3), in_win)``: positions in
    global grid units, ``~in_win`` rows frozen with no deposit (the model
    re-pushes them exactly).  ``precision`` names the reference's matmul
    strategy and is validated only: the port computes in f32
    (ops/precision.py).

    A CUDA ``position`` launches the Hopper kernel (or raises); a CPU one
    runs ``fused_em3d_substep_plain``."""
    resolve_precision(precision, getattr(tiling, "dtype", "float32"))
    if position.device.type == "cpu":
        return fused_em3d_substep_plain(
            table, position, velocity, valid, tile_id, shape, tiling,
            qm_half_dt, dt, cell_size, charge, c_light, relativistic)
    nts, n_tiles, k = _constants(shape, tiling, position, qm_half_dt, dt,
                                 cell_size, charge, c_light)
    return _launch(table, position, velocity, valid, tile_id, shape, tiling,
                   relativistic, nts, n_tiles, k)
