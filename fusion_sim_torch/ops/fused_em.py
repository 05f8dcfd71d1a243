"""Fused EM-PIC substep: gather + Boris kick + drift + Esirkepov deposit in
one kernel (2D3V, tile-sorted layout).

Port of ``fusion_sim_tpu/ops/pallas_em.py : fused_em2d_substep`` (kernel
B4 of the port).  Per row of the padded tile-sorted layout, in the block's
window-local frame (l = mod(x - origin, n), origin = the block's tile
corner minus the margin):

    E, B = CIC-gather(table, l0)      6 channels of the node-centered table
    u'   = Boris(u, E, B)             optionally relativistic (u = gamma v)
    l1   = l0 + dt v' / dx            drift (v' = u'/gamma' if relativistic)
    J   += Esirkepov(q, l0 -> l1)     3 components, charge conserving

then back to global periodic coordinates.  A row whose l0 (gather) or l1
(deposit) leaves ``[0, w - 1)`` on either axis comes back frozen (position
mod(l0 + origin, n), velocity as given) with no deposit and ``in_win =
False``; the model re-pushes it exactly from its input (its spill patch).
Rows of blocks carrying the sentinel tile id (``n_tiles``, the layout's
trailing dead blocks) have no window: they come back exactly as given,
``in_win = False``, no deposit.

The Esirkepov factors are the reference kernel's, node by node of the
window: tents ``S(l)[i] = max(0, 1 - |l - i|)`` and the closed-form
cumulative tent ``K[i] = clip(i - l1 + 1, 0, 1) - clip(i - l0 + 1, 0, 1)``:

    Jx[i, j] += (q cx K_r[i]) (S0_z[j] + dS_z[j]/2)
    Jy[i, j] += (S0_r[i] + dS_r[i]/2) (q cz K_z[j])
    Jz[i, j] += (q v'_z / V) [(S0_r[i] + dS_r[i]/2) S0_z[j]
                              + (S0_r[i]/2 + dS_r[i]/3) dS_z[j]]

with c = -d/(V dt); only the nodes floor(min(l0, l1)) .. floor(max(l0,
l1)) + 1 of each axis are nonzero (2 or 3 of them while the drift stays
under a cell; more for a faster row, which the window form covers too).

On a CUDA tensor ``fused_em2d_substep`` launches the hand-written kernel
``csrc/em2d_substep.cu`` (counted in ``LAUNCHES``) or raises; on a CPU
tensor it runs ``fused_em2d_substep_plain``, the same function in plain
PyTorch, which the tests hold against the JAX kernel and the card holds
the kernel against.

The kernel's design: one CTA owns one tile, which needs the layout's
blocks sorted by tile id as ``build_padded_layout`` and the repair keep
them; it stages its tile's field window in shared memory beside its J
window and flushes J once onto the grid; a row that stays in its cell
deposits a fixed 8-value stencil, summed over a warp's rows of one cell
before the shared adds; other charged rows go through a per-warp queue to
the general span loop.  A window whose fields do not fit in shared memory
beside J reads its corners through L1; one whose J does not fit either
(``em2d_substep_smem`` reports no form within the shared memory a block
can use) is refused with ValueError.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .fused_pic import _check
from .precision import resolve_precision
from .sorted_deposit import window_origins

LAUNCHES = 0  # kernel launches by fused_em2d_substep (CUDA tensors only)


def _constants(shape, tiling, position, qm_half_dt, dt, cell_size, charge,
               c_light):
    """Layout sizes and the scalars the kernel takes, rounded on the host
    as the reference rounds them (1/dx, -dx/(V dt), 1/V, 1/c^2)."""
    nr, nz = shape
    ntr, ntz = tiling.n_tiles(shape)
    if position.shape[0] % tiling.block:
        raise ValueError(f"N={position.shape[0]} not a multiple of "
                         f"block={tiling.block}")
    dx, dz = cell_size
    vol = dx * dz
    scalars = dict(qm_half_dt=float(qm_half_dt), dt=float(dt),
                   inv_dx=float(1.0 / dx), inv_dz=float(1.0 / dz),
                   coef_x=float(-dx / (vol * dt)),
                   coef_z=float(-dz / (vol * dt)), inv_vol=float(1.0 / vol),
                   inv_c2=float(1.0 / (c_light * c_light)),
                   charge=float(charge))
    if not all(math.isfinite(x) for x in scalars.values()):
        raise ValueError(f"non-finite substep constant in {scalars}")
    return nr, nz, ntz, ntr * ntz, scalars


def _tent(l, node):
    return torch.clamp(1.0 - torch.abs(l - node), min=0.0)


def _cum_tent(l0, l1, node):
    return (torch.clamp(node - l1 + 1.0, 0.0, 1.0)
            - torch.clamp(node - l0 + 1.0, 0.0, 1.0))


def fused_em2d_substep_plain(table, position, velocity, valid, tile_id,
                             shape, tiling, qm_half_dt, dt, cell_size,
                             charge, c_light: float = 1.0,
                             relativistic: bool = False):
    """The substep in plain PyTorch, with the kernel's operation order.

    Arguments and returns as ``fused_em2d_substep``.  The gather reads the
    table at the window cell's global (wrapped) index, which is the value
    the window holds, and the deposit adds into the grid at the wrapped
    index of the window node."""
    nr, nz, _, n_tiles, k = _constants(shape, tiling, position, qm_half_dt,
                                       dt, cell_size, charge, c_light)
    wr, wz = tiling.window()
    blk = tiling.block
    h = k["qm_half_dt"]
    otr_i, otz_i = window_origins(tile_id, shape, tiling)
    real_tile = (tile_id[::blk] < n_tiles).repeat_interleave(blk)
    otr_i = otr_i.repeat_interleave(blk)
    otz_i = otz_i.repeat_interleave(blk)
    otr, otz = otr_i.to(torch.float32), otz_i.to(torch.float32)
    vx, vy, vz = velocity[:, 0], velocity[:, 1], velocity[:, 2]

    l0r = torch.remainder(position[:, 0] - otr, float(nr))
    l0z = torch.remainder(position[:, 1] - otz, float(nz))
    g_inw = real_tile & (l0r < wr - 1) & (l0z < wz - 1)

    # 6-channel CIC gather, r first and then z (the reference's order)
    fi, fj = torch.floor(l0r), torch.floor(l0z)
    ar0, ar1 = (1.0 - (l0r - fi))[:, None], (1.0 - ((fi + 1.0) - l0r))[:, None]
    az0, az1 = (1.0 - (l0z - fj))[:, None], (1.0 - ((fj + 1.0) - l0z))[:, None]
    gi = torch.remainder(otr_i + fi.to(torch.int64), nr)
    gj = torch.remainder(otz_i + fj.to(torch.int64), nz)
    gi1, gj1 = torch.remainder(gi + 1, nr), torch.remainder(gj + 1, nz)
    eb = (az0 * (ar0 * table[gi, gj] + ar1 * table[gi1, gj])
          + az1 * (ar0 * table[gi, gj1] + ar1 * table[gi1, gj1]))
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
    nvx = vmx + (vpy * sz - vpz * sy) + h * ex
    nvy = vmy + (vpz * sx - vpx * sz) + h * ey
    nvz = vmz + (vpx * sy - vpy * sx) + h * ez

    # drift (coordinate velocity = u/gamma when relativistic)
    if relativistic:
        gamma1 = torch.sqrt(1.0 + (nvx * nvx + nvy * nvy + nvz * nvz)
                            * k["inv_c2"])
        cvx, cvy, cvz = nvx / gamma1, nvy / gamma1, nvz / gamma1
    else:
        cvx, cvy, cvz = nvx, nvy, nvz
    l1r = l0r + k["dt"] * cvx * k["inv_dx"]
    l1z = l0z + k["dt"] * cvy * k["inv_dz"]
    inw = (g_inw & (l1r >= 0.0) & (l1r < wr - 1)
           & (l1z >= 0.0) & (l1z < wz - 1))

    # Esirkepov deposit of the in-window charged rows, node by node
    j = torch.zeros((nr * nz, 3), dtype=torch.float32,
                    device=position.device)
    dep = inw & valid
    if bool(dep.any()):
        a0, a1, c0, c1 = l0r[dep], l1r[dep], l0z[dep], l1z[dep]
        o_r, o_z = otr_i[dep], otz_i[dep]
        q = torch.full_like(a0, k["charge"])
        qcx, qcz = q * k["coef_x"], q * k["coef_z"]
        qvz = q * cvz[dep] * k["inv_vol"]
        b_r = torch.floor(torch.minimum(a0, a1))
        b_z = torch.floor(torch.minimum(c0, c1))
        span_r = torch.floor(torch.maximum(a0, a1)) + 1.0 - b_r
        span_z = torch.floor(torch.maximum(c0, c1)) + 1.0 - b_z

        def factors(base, span, l0, l1, qc):
            out = []
            for step in range(int(span.max()) + 1):
                node = base + float(step)
                s0 = _tent(l0, node)
                ds = _tent(l1, node) - s0
                out.append((node.to(torch.int64), step <= span,
                            qc * _cum_tent(l0, l1, node), s0, ds))
            return out

        z_factors = factors(b_z, span_z, c0, c1, qcz)
        for i, ok_r, ax, s0r, dsr in factors(b_r, span_r, a0, a1, qcx):
            ay = s0r + 0.5 * dsr
            az1_, az2_ = qvz * ay, qvz * (0.5 * s0r + dsr / 3.0)
            gi = torch.remainder(o_r + i, nr)
            for jn, ok_z, by_, s0z, dsz in z_factors:
                vals = torch.stack([ax * (s0z + 0.5 * dsz), ay * by_,
                                    az1_ * s0z + az2_ * dsz], dim=-1)
                ok = ok_r & ok_z & (i < wr) & (jn < wz)
                gj = torch.remainder(o_z + jn, nz)
                j.index_add_(0, (gi * nz + gj)[ok], vals[ok])

    def out(moved, kept, given):
        return torch.where(real_tile, torch.where(inw, moved, kept), given)

    pos_out = torch.stack([
        out(torch.remainder(l1r + otr, float(nr)),
            torch.remainder(l0r + otr, float(nr)), position[:, 0]),
        out(torch.remainder(l1z + otz, float(nz)),
            torch.remainder(l0z + otz, float(nz)), position[:, 1])], dim=-1)
    vel_out = torch.stack([torch.where(inw, nvx, vx), torch.where(inw, nvy, vy),
                           torch.where(inw, nvz, vz)], dim=-1)
    return pos_out, vel_out, j.reshape(nr, nz, 3), inw


def _library():
    from . import _build

    lib = _build.load("em2d_substep")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.em2d_substep.argtypes = [p] * 9 + [i] * 10 + [f] * 9 + [p]
        lib.em2d_substep.restype = i
        lib.em2d_substep_smem.argtypes = [i] * 2
        lib.em2d_substep_smem.restype = ctypes.c_longlong
        lib.em2d_error_string.argtypes = [i]
        lib.em2d_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(table, position, velocity, valid, tile_id, shape, tiling,
            relativistic, nr, nz, ntz, n_tiles, k):
    global LAUNCHES
    n = position.shape[0]
    dev = position.device
    f32 = torch.float32
    # the table and the positions are read as float2: 8-byte aligned
    _check("table", table, f32, (nr, nz, 6), dev, align=8)
    _check("position", position, f32, (n, 2), dev, align=8)
    _check("velocity", velocity, f32, (n, 3), dev)
    _check("valid", valid, torch.bool, (n,), dev, align=1)
    _check("tile_id", tile_id, torch.int32, (n,), dev)
    if n >= 2 ** 31 // 3 or nr * nz >= 2 ** 31 // 6:
        raise ValueError("the kernel indexes values with 32-bit ints")
    lib = _library()
    # the current window (and the field window beside it where it fits)
    if lib.em2d_substep_smem(*tiling.window()) < 0:
        raise ValueError(
            f"a {tiling.window()} window's current does not fit in the "
            f"shared memory a block can use: take smaller tiles or a "
            f"smaller margin")
    pos_out = torch.empty_like(position)
    vel_out = torch.empty_like(velocity)
    j = torch.zeros((nr, nz, 3), dtype=f32, device=dev)
    in_win = torch.empty((n,), dtype=torch.bool, device=dev)
    err = lib.em2d_substep(
        table.data_ptr(), position.data_ptr(), velocity.data_ptr(),
        valid.data_ptr(), tile_id.data_ptr(), pos_out.data_ptr(),
        vel_out.data_ptr(), j.data_ptr(), in_win.data_ptr(),
        n, tiling.block, nr, nz, ntz, n_tiles, tiling.tile_r, tiling.tile_z,
        tiling.margin, int(bool(relativistic)),
        k["qm_half_dt"], k["dt"], k["inv_dx"], k["inv_dz"], k["coef_x"],
        k["coef_z"], k["inv_vol"], k["inv_c2"], k["charge"],
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("em2d_substep launch failed: "
                           + lib.em2d_error_string(err).decode())
    LAUNCHES += 1
    return pos_out, vel_out, j, in_win


def fused_em2d_substep(table, position, velocity, valid, tile_id, shape,
                       tiling, qm_half_dt: float, dt: float,
                       cell_size: tuple[float, float], charge: float,
                       c_light: float = 1.0, relativistic: bool = False,
                       precision: str = "highest"):
    """One fused EM particle substep for the tile-sorted 2D3V layout.

    ``table``: the (nr, nz, 6) f32 node-centered E|B table
    (ops/fdtd.center_fields); ``position`` (N, 2) and ``velocity`` (N, 3)
    f32 in the padded sorted layout (N = nb * tiling.block), ``valid``
    (N,) bool (fillers carry no charge), ``tile_id`` (N,) int32.  Returns
    ``(position', velocity', j (nr, nz, 3), in_win)``: positions in global
    grid units, ``~in_win`` rows frozen with no deposit (the model
    re-pushes them exactly).  ``precision`` names the reference's matmul
    strategy and is validated only: the port computes in f32
    (ops/precision.py).

    A CUDA ``position`` launches the Hopper kernel (or raises); a CPU one
    runs ``fused_em2d_substep_plain``."""
    resolve_precision(precision, getattr(tiling, "dtype", "float32"))
    if position.device.type == "cpu":
        return fused_em2d_substep_plain(
            table, position, velocity, valid, tile_id, shape, tiling,
            qm_half_dt, dt, cell_size, charge, c_light, relativistic)
    nr, nz, ntz, n_tiles, k = _constants(shape, tiling, position, qm_half_dt,
                                         dt, cell_size, charge, c_light)
    return _launch(table, position, velocity, valid, tile_id, shape, tiling,
                   relativistic, nr, nz, ntz, n_tiles, k)
