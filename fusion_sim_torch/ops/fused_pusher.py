"""Fused half-step of the tile-sorted grid-parity pusher (kernel B2).

Port of ``fusion_sim_tpu/ops/pallas_pusher.py : fused_pusher_substep``.
Per row of the padded tile-sorted layout, one leapfrog half-step
(empic.js:1436-1469) in its block's window frame (origin = the block's
tile corner minus the margin):

1. the NEAREST/CLAMP sample cell ``cell_coords`` and its window-local
   coordinate l = mod(cell - origin, n); the 12 coefficient channels
   R1|R2|R3|A at window cell floor(l) (``step_velocity_frag``,
   empic.js:749-773);
2. the cylindrical Boris rotation, or for fresh rows (alive <= 0.5) the
   thermal re-init 0.001 * (2u - 1) from ``rand[:, :3]``;
3. the drift x' = x + step_factor * v';
4. the sink channel at the drifted cell, window coordinate
   clip(cell') - origin with no periodic wrap (``step_position_frag``,
   empic.js:712-720);
5. rows whose first (wrapped) or second (unwrapped) sample leaves the
   window come back frozen at their inputs with sink = 1 and
   ``in_win = False``; the model re-pushes them exactly.

The packed (nr, nz, 13) table holds R1|R2|R3|A in channels 0-11 and the
sink mask in channel 12.  On a CUDA tensor ``fused_pusher_substep``
launches the hand-written kernel ``csrc/pusher_substep.cu`` (counted in
``LAUNCHES``) or raises; on a CPU tensor it runs
``fused_pusher_substep_plain``, the same function in plain PyTorch.  The
reference's streamed bf16-split windows (``build_pusher_windows``) are a
TPU means to an exact f32 selection and have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_pic import _check
from .sorted_deposit import Tiling2D, window_origins

LAUNCHES = 0  # kernel launches by fused_pusher_substep (CUDA only)
N_CHANNELS = 13


def cell_coords(position: torch.Tensor, nr: int, nz: int) -> torch.Tensor:
    """(r*nr, z*nz) clamped to [0, n - 1e-3]: the NEAREST/CLAMP sample cell
    in grid units (the reference's ``models/pusher_sorted._cell_coords``).
    Clamping reproduces CLAMP_TO_EDGE and keeps every coordinate inside
    the grid."""
    x, y, z = position[..., 0], position[..., 1], position[..., 2]
    r = torch.sqrt(x * x + y * y)
    cu = torch.clamp(r * nr, 0.0, nr - 1e-3)
    cv = torch.clamp(z * nz, 0.0, nz - 1e-3)
    return torch.stack([cu, cv], dim=-1)


def stream_tiling_for(nr: int, nz: int, margin: int = 6) -> Tiling2D:
    """The fused path's default tiling: the smallest r tile of at least 8
    rows and the widest z tile whose window fits 128 cells
    (``ops/pallas_pusher.py:317``; 400x800 -> 8 x 100 tiles, 21 x 113
    windows)."""
    div_z = [t for t in range(1, nz + 1)
             if nz % t == 0 and t + 2 * margin + 1 <= 128]
    div_r = [t for t in range(8, nr + 1) if nr % t == 0]
    if not div_z or not div_r:
        raise ValueError(
            f"no streaming tiling divides the {nr}x{nz} grid with margin "
            f"{margin} — pass an explicit Tiling2D")
    return Tiling2D(tile_r=min(div_r), tile_z=max(div_z), block=1024,
                    margin=margin)


def _validate(packed13, position, nr, nz, tiling):
    tiling.n_tiles((nr, nz))
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    if tuple(packed13.shape) != (nr, nz, N_CHANNELS):
        raise ValueError(f"packed13 has shape {tuple(packed13.shape)}, "
                         f"expected ({nr}, {nz}, {N_CHANNELS})")


def fused_pusher_substep_plain(packed13, position, velocity, alive, rand,
                               tile_id, nr, nz, tiling, step_factor):
    """The half-step in plain PyTorch, with the kernel's operation order;
    arguments and returns as ``fused_pusher_substep``."""
    _validate(packed13, position, nr, nz, tiling)
    wr, wz = tiling.window()
    tab = packed13.reshape(nr * nz, N_CHANNELS)
    otr_i, otz_i = (o.repeat_interleave(tiling.block)
                    for o in window_origins(tile_id, (nr, nz), tiling))
    otr, otz = otr_i.to(torch.float32), otz_i.to(torch.float32)

    cell = cell_coords(position, nr, nz)
    lcr = torch.remainder(cell[:, 0] - otr, float(nr))
    lcz = torch.remainder(cell[:, 1] - otz, float(nz))
    g_inw = (lcr >= 0.0) & (lcr < wr - 1) & (lcz >= 0.0) & (lcz < wz - 1)
    gi = torch.remainder(otr_i + torch.floor(lcr).to(torch.int64), nr)
    gj = torch.remainder(otz_i + torch.floor(lcz).to(torch.int64), nz)
    c = tab[gi * nz + gj]

    x, y, z = position[:, 0], position[:, 1], position[:, 2]
    vx, vy, vz = velocity[:, 0], velocity[:, 1], velocity[:, 2]
    r = torch.sqrt(x * x + y * y)
    dir_x = x / r
    dir_y = y / r
    vr = vx * dir_x + vy * dir_y
    va = vy * dir_x - vx * dir_y
    rot_r = c[:, 0] * vr + c[:, 1] * va + c[:, 2] * vz + c[:, 9]
    rot_a = c[:, 3] * vr + c[:, 4] * va + c[:, 5] * vz + c[:, 10]
    rot_z = c[:, 6] * vr + c[:, 7] * va + c[:, 8] * vz + c[:, 11]
    fresh = alive <= 0.5
    nvx = torch.where(fresh, 0.001 * (2.0 * rand[:, 0] - 1.0),
                      rot_r * dir_x - rot_a * dir_y)
    nvy = torch.where(fresh, 0.001 * (2.0 * rand[:, 1] - 1.0),
                      rot_r * dir_y + rot_a * dir_x)
    nvz = torch.where(fresh, 0.001 * (2.0 * rand[:, 2] - 1.0), rot_z)

    nx = x + step_factor * nvx
    ny = y + step_factor * nvy
    nzp = z + step_factor * nvz
    nrad = torch.sqrt(nx * nx + ny * ny)
    cu = torch.clamp(nrad * nr, 0.0, nr - 1e-3) - otr
    cv = torch.clamp(nzp * nz, 0.0, nz - 1e-3) - otz
    s_inw = (cu >= 0.0) & (cu < wr - 1) & (cv >= 0.0) & (cv < wz - 1)
    si = torch.remainder(otr_i + torch.floor(cu).to(torch.int64), nr)
    sj = torch.remainder(otz_i + torch.floor(cv).to(torch.int64), nz)
    sink = tab[si * nz + sj, 12]

    inw = g_inw & s_inw
    keep = inw[:, None]
    pos_out = torch.where(keep, torch.stack([nx, ny, nzp], dim=-1), position)
    vel_out = torch.where(keep, torch.stack([nvx, nvy, nvz], dim=-1),
                          velocity)
    return pos_out, vel_out, torch.where(inw, sink, 1.0), inw


def _library():
    from . import _build

    lib = _build.load("pusher_substep")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pusher_substep.argtypes = [p] * 10 + [i] * 8 + [f] * 3 + [p]
        lib.pusher_substep.restype = i
        lib.pusher_substep_error_string.argtypes = [i]
        lib.pusher_substep_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(packed13, position, velocity, alive, rand, tile_id, nr, nz,
            tiling, step_factor):
    global LAUNCHES
    n = position.shape[0]
    _, ntz = tiling.n_tiles((nr, nz))
    dev = position.device
    f32 = torch.float32
    _check("packed13", packed13, f32, (nr, nz, N_CHANNELS), dev)
    _check("position", position, f32, (n, 3), dev)
    _check("velocity", velocity, f32, (n, 3), dev)
    _check("alive", alive, f32, (n,), dev)
    _check("rand", rand, f32, (n, 4), dev, align=16)   # read as float4
    _check("tile_id", tile_id, torch.int32, (n,), dev)
    if 3 * n >= 2 ** 31:
        raise ValueError("the kernel indexes rows with 32-bit ints")
    pos_out = torch.empty_like(position)
    vel_out = torch.empty_like(velocity)
    sink = torch.empty((n,), dtype=f32, device=dev)
    in_win = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = _library()
    err = lib.pusher_substep(
        packed13.data_ptr(), position.data_ptr(), velocity.data_ptr(),
        alive.data_ptr(), rand.data_ptr(), tile_id.data_ptr(),
        pos_out.data_ptr(), vel_out.data_ptr(), sink.data_ptr(),
        in_win.data_ptr(), n, tiling.block, nr, nz, ntz, tiling.tile_r,
        tiling.tile_z, tiling.margin, nr - 1e-3, nz - 1e-3, step_factor,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("pusher_substep launch failed: "
                           + lib.pusher_substep_error_string(err).decode())
    LAUNCHES += 1
    return pos_out, vel_out, sink, in_win


def fused_pusher_substep(packed13, position, velocity, alive, rand, tile_id,
                         nr: int, nz: int, tiling, step_factor: float):
    """One fused pusher half-step on the padded tile-sorted layout.

    ``packed13`` (nr, nz, 13) f32: R1|R2|R3|A in channels 0-11, the sink
    mask in 12; ``position``/``velocity`` (N, 3) f32, ``alive`` (N,) f32,
    ``rand`` (N, 4) f32 this substep's uniforms, ``tile_id`` (N,) int32
    (N a multiple of ``tiling.block``).  Returns ``(position', velocity',
    sink (N,) f32, in_win (N,) bool)`` with ``~in_win`` rows frozen at
    their inputs and sink = 1.  The reference also takes the sample cells;
    here they are derived from ``position`` (``cell_coords``).

    A CUDA ``position`` launches the Hopper kernel (or raises); a CPU one
    runs ``fused_pusher_substep_plain``."""
    _validate(packed13, position, nr, nz, tiling)
    step_factor = float(step_factor)
    if position.device.type == "cpu":
        return fused_pusher_substep_plain(packed13, position, velocity,
                                          alive, rand, tile_id, nr, nz,
                                          tiling, step_factor)
    return _launch(packed13, position, velocity, alive, rand, tile_id, nr,
                   nz, tiling, step_factor)
