"""Fused 3D ES-PIC substep: gather + kick + drift + deposit in one kernel.

Port of ``fusion_sim_tpu/ops/pallas_pic3d.py : fused_es3d_substep`` (kernel
B5 of the port), the 3D form of ops/fused_pic.py.  Per row of the padded
tile-sorted layout, in the block's window-local frame (l = mod(x - origin,
n) per axis, origin = the block's tile corner minus the margin):

    E_p = CIC-gather(E, l)           3 channels, 8 corners of the window
    v'  = v + qm_dt * E_p            kick (0 for a weight-0 row)
    l'  = l + c * v'                 drift (c = dt / dx per axis)
    rho += CIC-deposit(w, l')        next step's charge

then back to global periodic coordinates, mod(l' + origin, n).  A row whose
l (gather, upper bounds only: l is a mod) or l' (deposit, both bounds)
leaves ``[0, w - 1)`` on any axis comes back frozen (position mod(l +
origin, n), velocity as given) with no deposit and ``in_win = False``; the
model re-pushes it exactly (its spill patch).  Rows of blocks carrying the
sentinel tile id (``n_tiles``, the layout's trailing dead blocks) have no
window: they come back exactly as given, ``in_win = False``, no deposit.

On a CUDA tensor ``fused_es3d_substep`` launches the hand-written kernel
``csrc/es3d_substep.cu`` (counted in ``LAUNCHES``) or raises; on a CPU
tensor it runs ``fused_es3d_substep_plain``, the same function in plain
PyTorch, which the tests hold against the JAX kernel and the card holds
the kernel against.  The kernel needs the layout's blocks sorted by tile
id, as ``build_padded_layout`` and the repair paths keep them; it is
fastest when each tile's rows are ordered by cell
(``build_padded_layout(cell_order=True)``, which the ES 3D shell uses).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .fused_pic import _check
from .precision import resolve_precision
from .sorted_deposit import window_origins_3d

LAUNCHES = 0  # kernel launches by fused_es3d_substep (CUDA tensors only)

SHARED_MEMORY_LIMIT = 232448  # bytes a block can use on Hopper (opt-in)


def _layout(shape, tiling, position):
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    nts = tiling.n_tiles(shape)
    return nts, math.prod(nts)


def local_frame_3d(position, tile_id, shape, tiling, n_tiles):
    """Per row: ``real_tile`` (its block has a window), the window origins
    per axis as int64 and as f32, and the window-local coordinates
    mod(x - origin, n) per axis."""
    blk = tiling.block
    real_tile = (tile_id[::blk] < n_tiles).repeat_interleave(blk)
    o_i = [o.repeat_interleave(blk)
           for o in window_origins_3d(tile_id, shape, tiling)]
    o_f = [o.to(torch.float32) for o in o_i]
    loc = [torch.remainder(position[:, a] - o_f[a], float(shape[a]))
           for a in range(3)]
    return real_tile, o_i, o_f, loc


def corner_cells_3d(loc, o_i, shape):
    """Per axis: floor(l) as f32, and the wrapped grid indices of the
    window cells floor(l) and floor(l) + 1."""
    f = [torch.floor(x) for x in loc]
    g0 = [torch.remainder(o_i[a] + f[a].to(torch.int64), shape[a])
          for a in range(3)]
    g1 = [torch.remainder(g + 1, shape[a]) for a, g in enumerate(g0)]
    return f, g0, g1


def fused_es3d_substep_plain(e_grid, position, velocity, weights, tile_id,
                             shape, tiling, qm_dt, c_x, c_y, c_z):
    """The substep in plain PyTorch, with the kernel's operation order.

    Arguments and returns as ``fused_es3d_substep``.  The gather reads the
    grid at the window cell's global (wrapped) index, which is the value
    the window holds, and the deposit adds into the grid at the wrapped
    index of the window cell it lands in."""
    _, n_tiles = _layout(shape, tiling, position)
    nx, ny, nz = shape
    wins = tiling.window()
    real_tile, o_i, o_f, loc = local_frame_3d(position, tile_id, shape,
                                              tiling, n_tiles)
    valid = weights != 0.0
    g_inw = (real_tile & (loc[0] < wins[0] - 1) & (loc[1] < wins[1] - 1)
             & (loc[2] < wins[2] - 1))

    f, g0, g1 = corner_cells_3d(loc, o_i, shape)
    a0 = [(1.0 - (loc[a] - f[a]))[:, None] for a in range(3)]
    a1 = [(1.0 - ((f[a] + 1.0) - loc[a]))[:, None] for a in range(3)]
    flat = e_grid.reshape(nx * ny * nz, 3)
    e = 0.0
    for gx, wx in ((g0[0], a0[0]), (g1[0], a1[0])):
        r0, r1 = (gx * ny + g0[1]) * nz, (gx * ny + g1[1]) * nz
        plane = ((a0[1] * a0[2]) * flat[r0 + g0[2]]
                 + (a0[1] * a1[2]) * flat[r0 + g1[2]]
                 + (a1[1] * a0[2]) * flat[r1 + g0[2]]
                 + (a1[1] * a1[2]) * flat[r1 + g1[2]])
        e = e + wx * plane
    c = (c_x, c_y, c_z)
    nv = [torch.where(valid, velocity[:, a] + qm_dt * e[:, a], 0.0)
          for a in range(3)]
    nl = [loc[a] + c[a] * nv[a] for a in range(3)]
    inw = g_inw
    for a in range(3):
        inw = inw & (nl[a] >= 0.0) & (nl[a] < wins[a] - 1)

    dep = inw & valid
    d_loc = [x[dep] for x in nl]
    f, g0, g1 = corner_cells_3d(d_loc, [o[dep] for o in o_i], shape)
    b0 = [1.0 - (d_loc[a] - f[a]) for a in range(3)]
    b1 = [1.0 - ((f[a] + 1.0) - d_loc[a]) for a in range(3)]
    w = weights[dep]
    rho = torch.zeros(nx * ny * nz, dtype=torch.float32,
                      device=position.device)
    for gy, by in ((g0[1], b0[1]), (g1[1], b1[1])):
        for gz, bz in ((g0[2], b0[2]), (g1[2], b1[2])):
            byz = (by * bz) * w
            for gx, bx in ((g0[0], b0[0]), (g1[0], b1[0])):
                rho.index_add_(0, (gx * ny + gy) * nz + gz, bx * byz)

    pos_out = torch.stack([
        torch.where(real_tile, torch.remainder(
            torch.where(inw, nl[a], loc[a]) + o_f[a], float(shape[a])),
            position[:, a]) for a in range(3)], dim=-1)
    vel_out = torch.stack([torch.where(inw, nv[a], velocity[:, a])
                           for a in range(3)], dim=-1)
    return pos_out, vel_out, rho.reshape(nx, ny, nz), inw


def _library():
    from . import _build

    lib = _build.load("es3d_substep")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.es3d_substep.argtypes = [p] * 9 + [i] * 12 + [f] * 4 + [p]
        lib.es3d_substep.restype = i
        lib.es3d_substep_smem.argtypes = [i] * 3
        lib.es3d_substep_smem.restype = ctypes.c_longlong
        lib.es3d_error_string.argtypes = [i]
        lib.es3d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(e_grid, position, velocity, weights, tile_id, shape, tiling,
            qm_dt, c_x, c_y, c_z):
    global LAUNCHES
    nts, n_tiles = _layout(shape, tiling, position)
    nx, ny, nz = shape
    n = position.shape[0]
    dev = position.device
    f32 = torch.float32
    _check("e_grid", e_grid, f32, (nx, ny, nz, 3), dev)
    _check("position", position, f32, (n, 3), dev)
    _check("velocity", velocity, f32, (n, 3), dev)
    _check("weights", weights, f32, (n,), dev)
    _check("tile_id", tile_id, torch.int32, (n,), dev)
    if n >= 2 ** 31 or nx * ny * nz >= 2 ** 31 // 3:
        raise ValueError("the kernel counts rows and grid values with "
                         "32-bit ints")
    lib = _library()
    # the E and rho windows
    smem = lib.es3d_substep_smem(*tiling.window())
    if smem > SHARED_MEMORY_LIMIT:
        raise ValueError(
            f"a {tiling.window()} window needs {smem} B of shared memory "
            f"for E and rho, above the {SHARED_MEMORY_LIMIT} B a block can "
            f"use: take smaller tiles or a smaller margin")
    pos_out = torch.empty_like(position)
    vel_out = torch.empty_like(velocity)
    rho = torch.zeros((nx, ny, nz), dtype=f32, device=dev)
    in_win = torch.empty((n,), dtype=torch.bool, device=dev)
    err = lib.es3d_substep(
        e_grid.data_ptr(), position.data_ptr(), velocity.data_ptr(),
        weights.data_ptr(), tile_id.data_ptr(), pos_out.data_ptr(),
        vel_out.data_ptr(), rho.data_ptr(), in_win.data_ptr(),
        n, tiling.block, nx, ny, nz,
        nts[1], nts[2], n_tiles, *tiling.tile, tiling.margin,
        qm_dt, c_x, c_y, c_z, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("es3d_substep launch failed: "
                           + lib.es3d_error_string(err).decode())
    LAUNCHES += 1
    return pos_out, vel_out, rho, in_win


def fused_es3d_substep(e_grid, position, velocity, weights, tile_id,
                       shape, tiling, qm_dt: float, c_x: float, c_y: float,
                       c_z: float, precision: str = "highest"):
    """One fused particle substep for tile-sorted 3D ES PIC.

    ``e_grid``: (nx, ny, nz, 3) f32; ``position``/``velocity`` (N, 3) f32
    in the padded sorted layout (N = nb * tiling.block), ``weights`` (N,)
    f32 (0 on fillers), ``tile_id`` (N,) int32.  Returns ``(position',
    velocity', rho', in_win)`` with the contract of ``fused_es2d_substep``:
    rho' (nx, ny, nz) is the charge deposited at the NEW positions and
    in_win flags rows whose gather AND deposit stayed inside their block
    window; ``~in_win`` rows come back frozen with no deposit.
    ``precision`` names the reference's matmul strategy and is validated
    only: the port computes in f32 (ops/precision.py).

    A CUDA ``position`` launches the Hopper kernel (or raises); a CPU one
    runs ``fused_es3d_substep_plain``."""
    resolve_precision(precision, getattr(tiling, "dtype", "float32"))
    if not all(math.isfinite(x) for x in (qm_dt, c_x, c_y, c_z)):
        raise ValueError("qm_dt, c_x, c_y and c_z must be finite")
    if position.device.type == "cpu":
        return fused_es3d_substep_plain(e_grid, position, velocity, weights,
                                        tile_id, shape, tiling, qm_dt, c_x,
                                        c_y, c_z)
    return _launch(e_grid, position, velocity, weights, tile_id, shape,
                   tiling, float(qm_dt), float(c_x), float(c_y), float(c_z))
