"""Windowed gather for tile-sorted particles (kernel B3 of the port).

Port of ``fusion_sim_tpu/ops/pallas_gather.py : gather_sorted_2d_pallas``:
per row of the padded tile-sorted layout, the C channels of a grid at the
row's position, read from its block's tile window.  The window-local
coordinate is ``l = mod(x - origin, n)`` in f32 (origin = the block's tile
corner minus the margin), and the window cell ``a`` is the grid cell
``(origin + a) mod n``:

* ``nearest``: the value at window cell floor(l) (0 past the window);
* ``cic``: tents max(0, 1 - |l - i|) at floor(l) and floor(l) + 1, each
  corner counted only inside the window, summed r first, then z;
* ``in_win``: floor(x) - origin inside the window, as the reference's
  criterion (values of other rows are for the caller to replace).

Note that floor(l) can differ by one from floor(x) - origin where
``x - origin`` rounds across an integer in f32; both are kept as the
reference has them.  ``gather_sorted_2d`` (ops/sorted_deposit.py) is the
other route, which clips floor(x) - origin into the window instead.

On a CUDA tensor ``gather_sorted_2d_window`` launches the hand-written
kernel ``csrc/gather2d.cu`` (counted in ``LAUNCHES``, and by form in
``FORM_LAUNCHES``) or raises; on a CPU tensor it runs
``gather_sorted_2d_window_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_pic import _check
from .precision import resolve_precision
from .sorted_deposit import window_origins

LAUNCHES = 0  # kernel launches by gather_sorted_2d_window (CUDA only)
# the same launches by form ("nearest C=12", "cic C=6", ...)
FORM_LAUNCHES: dict[str, int] = {}
MODES = ("nearest", "cic")


def _prepare(grid, position, tile_id, shape, tiling, mode, precision):
    resolve_precision(precision, getattr(tiling, "dtype", "float32"))
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} (one of {MODES})")
    nr, nz = shape
    tiling.n_tiles(shape)
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    if tuple(grid.shape[:2]) != (nr, nz):
        raise ValueError(f"grid has shape {tuple(grid.shape)}, expected "
                         f"({nr}, {nz}[, C])")
    return tuple(grid.shape[2:])


def gather_sorted_2d_window_plain(grid, position, tile_id, shape, tiling,
                                  mode: str = "cic",
                                  precision: str = "highest"):
    """The gather in plain PyTorch, with the kernel's operation order;
    arguments and returns as ``gather_sorted_2d_window``."""
    channels = _prepare(grid, position, tile_id, shape, tiling, mode,
                        precision)
    nr, nz = shape
    wr, wz = tiling.window()
    n = position.shape[0]
    flat = grid.reshape(nr * nz, -1)
    otr_i, otz_i = (o.repeat_interleave(tiling.block)
                    for o in window_origins(tile_id, shape, tiling))
    lr = torch.remainder(position[:, 0] - otr_i.to(torch.float32), float(nr))
    lz = torch.remainder(position[:, 1] - otz_i.to(torch.float32), float(nz))
    fi, fj = torch.floor(lr), torch.floor(lz)
    i, j = fi.to(torch.int64), fj.to(torch.int64)
    gi = torch.remainder(otr_i + i, nr)
    gj = torch.remainder(otz_i + j, nz)
    if mode == "nearest":
        out = torch.where(((i < wr) & (j < wz))[:, None], flat[gi * nz + gj],
                          0.0)
    else:
        gi1 = torch.remainder(otr_i + i + 1, nr)
        gj1 = torch.remainder(otz_i + j + 1, nz)
        ar0 = torch.where(i < wr, 1.0 - (lr - fi), 0.0)[:, None]
        ar1 = torch.where(i + 1 < wr, 1.0 - ((fi + 1.0) - lr), 0.0)[:, None]
        az0 = torch.where(j < wz, 1.0 - (lz - fj), 0.0)[:, None]
        az1 = torch.where(j + 1 < wz, 1.0 - ((fj + 1.0) - lz), 0.0)[:, None]
        out = (az0 * (ar0 * flat[gi * nz + gj] + ar1 * flat[gi1 * nz + gj])
               + az1 * (ar0 * flat[gi * nz + gj1]
                        + ar1 * flat[gi1 * nz + gj1]))
    base = torch.floor(position).to(torch.int64)
    dr = torch.remainder(base[:, 0] - otr_i, nr)
    dz = torch.remainder(base[:, 1] - otz_i, nz)
    in_win = (dr < wr - 1) & (dz < wz - 1)
    return out.reshape(n, *channels), in_win


def _library():
    from . import _build

    lib = _build.load("gather2d")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gather2d.argtypes = [p] * 5 + [i] * 10 + [p]
        lib.gather2d.restype = i
        lib.gather2d_error_string.argtypes = [i]
        lib.gather2d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(grid, position, tile_id, shape, tiling, mode, channels):
    global LAUNCHES
    nr, nz = shape
    _, ntz = tiling.n_tiles(shape)
    n = position.shape[0]
    n_c = 1
    for c in channels:
        n_c *= c
    dev = position.device
    _check("grid", grid, torch.float32, (nr, nz, *channels), dev)
    _check("position", position, torch.float32, (n, 2), dev, align=8)
    _check("tile_id", tile_id, torch.int32, (n,), dev)
    if n >= 2 ** 31 or nr * nz >= 2 ** 31:
        raise ValueError("the kernel counts rows and grid cells with 32-bit "
                         "ints")
    out = torch.empty((n, n_c), dtype=torch.float32, device=dev)
    in_win = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = _library()
    err = lib.gather2d(
        grid.data_ptr(), position.data_ptr(), tile_id.data_ptr(),
        out.data_ptr(), in_win.data_ptr(), n, n_c, tiling.block, nr, nz, ntz,
        tiling.tile_r, tiling.tile_z, tiling.margin, int(mode == "cic"),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("gather2d launch failed: "
                           + lib.gather2d_error_string(err).decode())
    LAUNCHES += 1
    form = f"{mode} C={n_c}"
    FORM_LAUNCHES[form] = FORM_LAUNCHES.get(form, 0) + 1
    return out.reshape(n, *channels), in_win


def gather_sorted_2d_window(grid, position, tile_id, shape, tiling,
                            mode: str = "cic", precision: str = "highest"):
    """Windowed gather of ``grid`` (nr, nz[, C]) f32 at ``position`` (N, 2)
    f32 grid units of the padded tile-sorted layout, ``tile_id`` (N,)
    int32.  Returns ``(values (N[, C]), in_win (N,) bool)``; values of
    ``~in_win`` rows are not meaningful.  ``precision`` names the
    reference's matmul strategy and is validated only: the port gathers in
    f32 (ops/precision.py).

    A CUDA ``position`` launches the Hopper kernel (or raises); a CPU one
    runs ``gather_sorted_2d_window_plain``."""
    channels = _prepare(grid, position, tile_id, shape, tiling, mode,
                        precision)
    if position.device.type == "cpu":
        return gather_sorted_2d_window_plain(grid, position, tile_id, shape,
                                             tiling, mode, precision)
    return _launch(grid, position, tile_id, shape, tiling, mode, channels)
