"""Plain PyTorch reference of one 2D3V electromagnetic PIC step.

Two space dimensions (x, y), three velocity and field components, every
derivative along z zero: the Weibel (filamentation) geometry.  Written
from the published schemes: the 2D Yee lattice, averaged to the nodes
once a step for a cloud-in-cell (CIC) gather; the non-relativistic Boris
rotation and the drift of x and y; Esirkepov's charge-conserving current
(CPC 135 (2001) 144) in its 2D form with the out-of-plane component; the
Yee leapfrog B half step, E full step, B half step with d/dz = 0,
forward differences from E to B and backward from B to E.

Departures from the paper, each the program's convention too: positions
are in grid units on a periodic grid, with values at integer nodes; the
step gathers from the node table (each staggered component averaged with
its neighbour below, as ``pic.center`` does) where the paper interpolates
each component at its own points; J_z takes the velocity after the kick,
v_z^(n+1/2), and sits at the nodes, as E_z does.

It imports neither JAX nor the port: it works from positions, velocities
and fields handed to it, in plain ``torch`` operations, in blocks of rows
(the CIC ``gather``, ``wrap``, ``boris`` and the stencil helpers of
``pic.py``).  ``fdtype`` is the precision of everything but positions
(grids, velocities, fields, weights): float32 is the reference, bfloat16
the lower-precision control.
"""

from __future__ import annotations

import torch

from .pic import (ROWS, _as, _dminus, _dplus, _running_sum3, _shape3, boris,
                  gather, wrap)
from .pic import yee_divergence  # noqa: F401  (of any rank: div E here)

# offsets of each component from the node, in cells along (x, y)
E_OFFSETS = ((0.5, 0.0), (0.0, 0.5), (0.0, 0.0))
B_OFFSETS = ((0.0, 0.5), (0.5, 0.0), (0.5, 0.5))


def center(e: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The (nx, ny, 6) node table (Ex, Ey, Ez, Bx, By, Bz): a component
    stored half a cell up an axis is averaged with its neighbour below."""
    cols = []
    for field, offsets in ((e, E_OFFSETS), (b, B_OFFSETS)):
        for comp, off in enumerate(offsets):
            c = field[..., comp]
            for axis, o in enumerate(off):
                if o:
                    c = 0.5 * (c + torch.roll(c, 1, axis))
            cols.append(c)
    return torch.stack(cols, dim=-1)


def esirkepov(x0: torch.Tensor, x1: torch.Tensor, vz: torch.Tensor,
              q: float, dt: float, shape, cell_size,
              fdtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Esirkepov current (nx, ny, 3) of particles moving x0 -> x1 (x0
    wrapped, x1 = x0 + displacement, under a cell an axis) with
    out-of-plane velocity ``vz``.  Jx sits half a cell up x, Jy half a
    cell up y, Jz at the node:

        Jx = -q dx / (V dt) * running sum along x of dS_x (S0_y + dS_y / 2)
        Jy = -q dy / (V dt) * running sum along y of dS_y (S0_x + dS_x / 2)
        Jz = q vz / V * [S0_x S0_y + (dS_x S0_y + S0_x dS_y) / 2
                         + dS_x dS_y / 3]

    with V = dx dy and S the CIC weights on the three nodes from the
    floor of min(x0, x1) up."""
    nx, ny = shape
    dx, dy = cell_size
    vol = dx * dy
    grid = torch.zeros((nx * ny, 3), dtype=fdtype, device=x0.device)
    k = torch.arange(3, device=x0.device)
    for lo in range(0, x0.shape[0], ROWS):
        a0, a1 = x0[lo:lo + ROWS], x1[lo:lo + ROWS]
        base = [torch.floor(torch.minimum(a0[:, c], a1[:, c])).to(torch.int64)
                for c in range(2)]
        s0 = [_as(_shape3(a0[:, c], base[c]), fdtype) for c in range(2)]
        ds = [_as(_shape3(a1[:, c], base[c]), fdtype) - s0[c]
              for c in range(2)]
        # (rows, 3 x nodes, 3 y nodes)
        wx = ds[0][:, :, None] * (s0[1] + 0.5 * ds[1])[:, None, :]
        wy = (s0[0] + 0.5 * ds[0])[:, :, None] * ds[1][:, None, :]
        wz = (s0[0][:, :, None] * s0[1][:, None, :]
              + 0.5 * (ds[0][:, :, None] * s0[1][:, None, :]
                       + s0[0][:, :, None] * ds[1][:, None, :])
              + (1.0 / 3.0) * ds[0][:, :, None] * ds[1][:, None, :])
        vals = torch.stack(
            [(-q * dx / (vol * dt)) * _running_sum3(wx, 1),
             (-q * dy / (vol * dt)) * _running_sum3(wy, 2),
             (q / vol) * _as(vz[lo:lo + ROWS], fdtype)[:, None, None] * wz],
            dim=-1)
        gx = torch.remainder(base[0][:, None] + k, nx)[:, :, None]
        gy = torch.remainder(base[1][:, None] + k, ny)[:, None, :]
        grid.index_add_(0, (gx * ny + gy).reshape(-1),
                        _as(vals, fdtype).reshape(-1, 3))
    return grid.reshape(nx, ny, 3)


def _curl(f, dx, diff):
    """Curl with d/dz = 0: (d_y fz, -d_x fz, d_x fy - d_y fx)."""
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([diff(fz, 1, dx[1]), -diff(fz, 0, dx[0]),
                        diff(fy, 0, dx[0]) - diff(fx, 1, dx[1])], dim=-1)


def yee(e: torch.Tensor, b: torch.Tensor, j: torch.Tensor, dt: float, dx,
        c: float = 1.0, eps0: float = 1.0):
    """B half step, E full step with J, B half step (periodic 2D Yee)."""
    b = b - (0.5 * dt) * _curl(e, dx, _dplus)
    e = e + dt * ((c * c) * _curl(b, dx, _dminus) - j / eps0)
    return e, b - (0.5 * dt) * _curl(e, dx, _dplus)


def em_step(cfg: dict, x0: torch.Tensor, v0: torch.Tensor, e0: torch.Tensor,
            b0: torch.Tensor, fdtype: torch.dtype = torch.float32):
    """One 2D3V EM step of the real particles (x0 (N, 2), v0 (N, 3)):
    node table from (e0, b0), Boris kick, drift of x and y, Esirkepov
    current, Yee update.  Returns ``(x1 wrapped, v1, e1, b1)``; all but
    x1 in ``fdtype``."""
    shape, dx = tuple(cfg["grid_shape"]), tuple(cfg["cell_size"])
    e0, b0 = _as(e0, fdtype), _as(b0, fdtype)
    table = center(e0, b0)
    qm_half_dt = cfg["charge"] / cfg["mass"] * cfg["dt"] * 0.5
    dxt = torch.tensor(dx, dtype=torch.float32, device=x0.device)
    v1 = torch.empty(v0.shape, dtype=fdtype, device=v0.device)
    x1 = torch.empty_like(x0)
    for lo in range(0, x0.shape[0], ROWS):
        xb = wrap(x0[lo:lo + ROWS], shape)
        eb = gather(table, xb, shape)
        v1[lo:lo + ROWS] = boris(_as(v0[lo:lo + ROWS], fdtype), eb[:, :3],
                                 eb[:, 3:], qm_half_dt)
        x1[lo:lo + ROWS] = (xb + cfg["dt"] * v1[lo:lo + ROWS, :2].float()
                            / dxt)
    j = esirkepov(wrap(x0, shape), x1, v1[:, 2], cfg["charge"], cfg["dt"],
                  shape, dx, fdtype)
    e1, b1 = yee(e0, b0, j, cfg["dt"], dx, cfg.get("c", 1.0),
                 cfg.get("eps0", 1.0))
    return wrap(x1, shape), v1, e1, b1
