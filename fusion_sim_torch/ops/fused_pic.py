"""Fused ES-PIC substep: gather + kick + drift + deposit in one kernel.

Port of ``fusion_sim_tpu/ops/pallas_pic.py : fused_es2d_substep`` (kernel
B1 of the port).  Per row of the padded tile-sorted layout, in the block's
window-local frame:

    E_p = CIC-gather(E, x)           from the block's tile window
    v'  = v + qm_dt * E_p            kick
    x'  = x + c * v'                 drift (c = dt / dx per axis)
    rho += CIC-deposit(w, x')        next step's charge

then back to global periodic coordinates.  Rows whose gather or deposit
leaves their window come back frozen at their inputs with no deposit and
``in_win = False``; the model re-pushes them exactly (its spill patch).

On a CUDA tensor ``fused_es2d_substep`` launches the hand-written kernel
``csrc/es2d_substep.cu`` (counted in ``LAUNCHES``) or raises; on a CPU
tensor it runs ``fused_es2d_substep_plain``, the same function in plain
PyTorch, which the tests hold against the JAX kernel and the card holds
the kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .precision import resolve_precision
from .sorted_deposit import window_origins

LAUNCHES = 0  # kernel launches by fused_es2d_substep (CUDA tensors only)


def _layout(shape, tiling, position):
    nr, nz = shape
    ntr, ntz = tiling.n_tiles(shape)
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    return nr, nz, ntz, ntr * ntz


def fused_es2d_substep_plain(e_grid, position, velocity, weights, tile_id,
                             shape, tiling, qm_dt, c_r, c_z):
    """The substep in plain PyTorch, with the kernel's operation order.

    Arguments and returns as ``fused_es2d_substep``.  The gather reads the
    grid at the window cell's global (wrapped) index, which is the value
    the window holds, and the deposit adds into the grid at the wrapped
    index of the window cell it lands in."""
    nr, nz, _, n_tiles = _layout(shape, tiling, position)
    wr, wz = tiling.window()
    blk = tiling.block
    otr_i, otz_i = window_origins(tile_id, shape, tiling)
    real_tile = (tile_id[::blk] < n_tiles).repeat_interleave(blk)
    otr_i = otr_i.repeat_interleave(blk)
    otz_i = otz_i.repeat_interleave(blk)
    otr, otz = otr_i.to(torch.float32), otz_i.to(torch.float32)
    pr, pz = position[:, 0], position[:, 1]
    vr, vz = velocity[:, 0], velocity[:, 1]
    w = torch.where(real_tile, weights, 0.0)
    valid = w != 0.0

    lr = torch.remainder(pr - otr, float(nr))
    lz = torch.remainder(pz - otz, float(nz))
    g_inw = (lr < wr - 1) & (lz < wz - 1)
    fi, fj = torch.floor(lr), torch.floor(lz)
    ar0, ar1 = 1.0 - (lr - fi), 1.0 - ((fi + 1.0) - lr)
    az0, az1 = 1.0 - (lz - fj), 1.0 - ((fj + 1.0) - lz)
    gi = torch.remainder(otr_i + fi.to(torch.int64), nr)
    gj = torch.remainder(otz_i + fj.to(torch.int64), nz)
    gi1, gj1 = torch.remainder(gi + 1, nr), torch.remainder(gj + 1, nz)
    e00, e10 = e_grid[gi, gj], e_grid[gi1, gj]
    e01, e11 = e_grid[gi, gj1], e_grid[gi1, gj1]
    e = (az0[:, None] * (ar0[:, None] * e00 + ar1[:, None] * e10)
         + az1[:, None] * (ar0[:, None] * e01 + ar1[:, None] * e11))
    nvr = torch.where(valid, vr + qm_dt * e[:, 0], 0.0)
    nvz = torch.where(valid, vz + qm_dt * e[:, 1], 0.0)
    nlr = lr + c_r * nvr
    nlz = lz + c_z * nvz
    inw = (g_inw & (nlr >= 0.0) & (nlr < wr - 1)
           & (nlz >= 0.0) & (nlz < wz - 1))

    dep = inw & valid
    fi, fj = torch.floor(nlr[dep]), torch.floor(nlz[dep])
    br0 = 1.0 - (nlr[dep] - fi)
    br1 = 1.0 - ((fi + 1.0) - nlr[dep])
    bz0 = (1.0 - (nlz[dep] - fj)) * w[dep]
    bz1 = (1.0 - ((fj + 1.0) - nlz[dep])) * w[dep]
    gi = torch.remainder(otr_i[dep] + fi.to(torch.int64), nr)
    gj = torch.remainder(otz_i[dep] + fj.to(torch.int64), nz)
    gi1, gj1 = torch.remainder(gi + 1, nr), torch.remainder(gj + 1, nz)
    rho = torch.zeros(nr * nz, dtype=torch.float32, device=position.device)
    for ii, jj, val in ((gi, gj, br0 * bz0), (gi, gj1, br0 * bz1),
                        (gi1, gj, br1 * bz0), (gi1, gj1, br1 * bz1)):
        rho.index_add_(0, ii * nz + jj, val)

    nlr = torch.where(inw, nlr, lr)
    nlz = torch.where(inw, nlz, lz)
    nvr = torch.where(inw, nvr, vr)
    nvz = torch.where(inw, nvz, vz)
    pos_out = torch.stack([torch.remainder(nlr + otr, float(nr)),
                           torch.remainder(nlz + otz, float(nz))], dim=-1)
    return (pos_out, torch.stack([nvr, nvz], dim=-1), rho.reshape(nr, nz),
            inw)


def _library():
    from . import _build

    lib = _build.load("es2d_substep")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.es2d_substep.argtypes = [p] * 9 + [i] * 9 + [f] * 3 + [p]
        lib.es2d_substep.restype = i
        lib.es2d_error_string.argtypes = [i]
        lib.es2d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name, t, dtype, shape, device, align=4):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         f"aligned")


def _launch(e_grid, position, velocity, weights, tile_id, shape, tiling,
            qm_dt, c_r, c_z):
    global LAUNCHES
    nr, nz, ntz, n_tiles = _layout(shape, tiling, position)
    n = position.shape[0]
    dev = position.device
    f32 = torch.float32
    # (.., 2) f32 arrays are read as float2: 8-byte aligned
    _check("e_grid", e_grid, f32, (nr, nz, 2), dev, align=8)
    _check("position", position, f32, (n, 2), dev, align=8)
    _check("velocity", velocity, f32, (n, 2), dev, align=8)
    _check("weights", weights, f32, (n,), dev)
    _check("tile_id", tile_id, torch.int32, (n,), dev)
    if n >= 2 ** 31 or nr * nz >= 2 ** 31:
        raise ValueError("the kernel indexes rows and cells with 32-bit ints")
    pos_out = torch.empty_like(position)
    vel_out = torch.empty_like(velocity)
    rho = torch.zeros((nr, nz), dtype=f32, device=dev)
    in_win = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = _library()
    err = lib.es2d_substep(
        e_grid.data_ptr(), position.data_ptr(), velocity.data_ptr(),
        weights.data_ptr(), tile_id.data_ptr(), pos_out.data_ptr(),
        vel_out.data_ptr(), rho.data_ptr(), in_win.data_ptr(),
        n, tiling.block, nr, nz, ntz, n_tiles, tiling.tile_r,
        tiling.tile_z, tiling.margin, qm_dt, c_r, c_z,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("es2d_substep launch failed: "
                           + lib.es2d_error_string(err).decode())
    LAUNCHES += 1
    return pos_out, vel_out, rho, in_win


def fused_es2d_substep(e_grid, position, velocity, weights, tile_id,
                       shape, tiling, qm_dt: float, c_r: float, c_z: float,
                       precision: str = "highest"):
    """One fused particle substep for tile-sorted 2D ES PIC.

    ``e_grid``: (nr, nz, 2) f32; ``position``/``velocity`` (N, 2) f32 in
    the padded sorted layout (N = nb * tiling.block), ``weights`` (N,) f32
    (0 on fillers; rows of sentinel-tile blocks count as weightless),
    ``tile_id`` (N,) int32.  Returns ``(position', velocity', rho',
    in_win)``: rho' (nr, nz) is the charge deposited at the NEW positions
    and in_win flags rows whose gather AND deposit stayed inside their
    block window; ``~in_win`` rows come back frozen at their inputs with no
    deposit.  ``precision`` names the reference's matmul strategy and is
    validated only: the port computes in f32 (ops/precision.py).

    A CUDA ``position`` launches the Hopper kernel (or raises); a CPU one
    runs ``fused_es2d_substep_plain``."""
    resolve_precision(precision, getattr(tiling, "dtype", "float32"))
    if not all(math.isfinite(x) for x in (qm_dt, c_r, c_z)):
        raise ValueError("qm_dt, c_r and c_z must be finite")
    if position.device.type == "cpu":
        return fused_es2d_substep_plain(e_grid, position, velocity, weights,
                                        tile_id, shape, tiling, qm_dt, c_r,
                                        c_z)
    return _launch(e_grid, position, velocity, weights, tile_id, shape,
                   tiling, float(qm_dt), float(c_r), float(c_z))
