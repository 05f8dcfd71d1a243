"""Esirkepov charge-conserving current deposition (CIC order, 2D3V and 3D).

Port of ``fusion_sim_tpu/ops/esirkepov.py``.  Esirkepov's density
decomposition (CPC 135 (2001) 144) builds J from the particle motion
x0 -> x1 so that the discrete continuity equation

    (rho1 - rho0)/dt + div_Yee J = 0

holds at every node, with rho the CIC-deposited density and div_Yee the
staggered Yee divergence: Gauss's law stays satisfied with no divergence
cleaning.

Layout: J is packed (*grid_shape, 3) with Jx at (i+1/2, j[, k]), Jy at
(i, j+1/2[, k]), Jz at (i, j, k+1/2) in 3D and collocated at the nodes in
2D3V (a vz-weighted deposit, Esirkepov eq. 39).

Every particle adds onto a 3-node stencil per axis (the CIC supports of
the start and end positions union to <= 3 nodes while |dx| < 1 cell).
The reference packs the 27 stencil values into one scatter row per
particle (81 in 3D), a TPU form; here ``index_add_`` adds the 9 (27)
stencil nodes onto the wrapped grid, which is the same sum.
"""

from __future__ import annotations

import torch


def _shapes_1d(x: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """CIC weights of positions ``x`` (N,) at stencil nodes base+{0,1,2};
    returns (N, 3)."""
    k = torch.arange(3, dtype=torch.float32, device=x.device)
    d = torch.abs(x[:, None] - (base[:, None].to(torch.float32) + k[None]))
    return torch.clamp(1.0 - d, min=0.0)


def stencil_base(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Common 3-node stencil base: floor(min(x0, x1)) per particle, int64."""
    return torch.floor(torch.minimum(x0, x1)).to(torch.int64)


def cumsum3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Running sum along a stencil axis of size 3, as two adds
    (``torch.cumsum`` on the card runs a general scan, which is slow on so
    short an axis)."""
    a, b, c = x.unbind(dim)
    ab = a + b
    return torch.stack([a, ab, ab + c], dim=dim)


def esirkepov_deposit_2d(x0: torch.Tensor, x1: torch.Tensor,
                         vz: torch.Tensor, charge, dt: float,
                         shape: tuple[int, int],
                         cell_size: tuple[float, float]) -> torch.Tensor:
    """Current of particles moving x0 -> x1 (grid units) over dt (2D3V).

    ``x0``/``x1``: (N, 2) positions before/after the drift (must differ by
    < 1 cell per axis; ``x1`` may be unwrapped); ``vz``: (N,) out-of-plane
    velocity (physical); ``charge``: scalar or (N,).  Returns (*shape, 3)
    current density."""
    nx, ny = shape
    dx, dy = cell_size
    vol = dx * dy
    n = x0.shape[0]
    q = torch.as_tensor(charge, dtype=torch.float32,
                        device=x0.device).expand(n)

    bx = stencil_base(x0[:, 0], x1[:, 0])
    by = stencil_base(x0[:, 1], x1[:, 1])
    s0x = _shapes_1d(x0[:, 0], bx)   # (N, 3)
    s1x = _shapes_1d(x1[:, 0], bx)
    s0y = _shapes_1d(x0[:, 1], by)
    s1y = _shapes_1d(x1[:, 1], by)
    dsx = s1x - s0x
    dsy = s1y - s0y

    # Esirkepov 2D decomposition weights over the 3x3 stencil
    wx = dsx[:, :, None] * (s0y + 0.5 * dsy)[:, None, :]            # (N,3,3)
    wy = dsy[:, None, :] * (s0x + 0.5 * dsx)[:, :, None]
    wz = (s0x[:, :, None] * s0y[:, None, :]
          + 0.5 * dsx[:, :, None] * s0y[:, None, :]
          + 0.5 * s0x[:, :, None] * dsy[:, None, :]
          + (1.0 / 3.0) * dsx[:, :, None] * dsy[:, None, :])

    # Jx(i+1/2, j) = -q dx/(V dt) * cumsum_x W_x ; likewise Jy along y
    coef = (q / (vol * dt))[:, None, None]
    jx_vals = -coef * dx * cumsum3(wx, 1)
    jy_vals = -coef * dy * cumsum3(wy, 2)
    jz_vals = (q * vz / vol)[:, None, None] * wz
    vals = torch.stack([jx_vals, jy_vals, jz_vals], dim=-1)  # (N, 3, 3, 3c)

    k = torch.arange(3, device=x0.device)
    flat = (torch.remainder(bx[:, None] + k, nx)[:, :, None] * ny
            + torch.remainder(by[:, None] + k, ny)[:, None, :])  # (N, 3, 3)
    grid = torch.zeros((nx * ny, 3), dtype=torch.float32, device=x0.device)
    grid.index_add_(0, flat.reshape(-1), vals.reshape(-1, 3))
    return grid.reshape(nx, ny, 3)


_ROWS_3D = 1 << 20  # rows per pass of esirkepov_deposit_3d


def esirkepov_deposit_3d(x0: torch.Tensor, x1: torch.Tensor, charge,
                         dt: float, shape: tuple[int, int, int],
                         cell_size: tuple[float, float, float]
                         ) -> torch.Tensor:
    """Full 3D Esirkepov deposition of particles moving x0 -> x1 (grid
    units, under a cell per axis; ``x1`` may be unwrapped) over dt;
    ``charge`` scalar or (N,).  Returns (*shape, 3) current density.

    Component a (b, c the other two axes) has the weight
    W_a = dS_a [S0_b S0_c + (dS_b S0_c + S0_b dS_c)/2 + dS_b dS_c/3] and
    J_a = -q d_a/(V dt) cumsum_a W_a.  Rows are processed ``_ROWS_3D`` at a
    time: the stencil holds 81 values a row."""
    nx, ny, nz = shape
    vol = cell_size[0] * cell_size[1] * cell_size[2]
    n = x0.shape[0]
    q_all = torch.as_tensor(charge, dtype=torch.float32,
                            device=x0.device).expand(n)
    grid = torch.zeros((nx * ny * nz, 3), dtype=torch.float32,
                       device=x0.device)
    k = torch.arange(3, device=x0.device)
    for lo in range(0, n, _ROWS_3D):
        a0, a1 = x0[lo:lo + _ROWS_3D], x1[lo:lo + _ROWS_3D]
        q = q_all[lo:lo + _ROWS_3D]
        bases = [stencil_base(a0[:, c], a1[:, c]) for c in range(3)]
        s0 = [_shapes_1d(a0[:, c], bases[c]) for c in range(3)]
        ds = [_shapes_1d(a1[:, c], bases[c]) - s0[c] for c in range(3)]
        coef = (q / (vol * dt))[:, None, None, None]
        j_vals = []
        for axis in range(3):
            b, c = [a for a in range(3) if a != axis]           # b < c
            mix = (s0[b][:, :, None] * s0[c][:, None, :]
                   + 0.5 * (ds[b][:, :, None] * s0[c][:, None, :]
                            + s0[b][:, :, None] * ds[c][:, None, :])
                   + (1.0 / 3.0) * (ds[b][:, :, None] * ds[c][:, None, :]))
            shape4 = [q.shape[0], 1, 1, 1]
            shape4[1 + axis] = 3
            w = ds[axis].reshape(shape4) * mix.unsqueeze(1 + axis)
            j_vals.append(-coef * cell_size[axis] * cumsum3(w, 1 + axis))
        vals = torch.stack(j_vals, dim=-1)                  # (n, 3, 3, 3, 3c)
        gx = torch.remainder(bases[0][:, None] + k, nx)[:, :, None, None]
        gy = torch.remainder(bases[1][:, None] + k, ny)[:, None, :, None]
        gz = torch.remainder(bases[2][:, None] + k, nz)[:, None, None, :]
        grid.index_add_(0, ((gx * ny + gy) * nz + gz).reshape(-1),
                        vals.reshape(-1, 3))
    return grid.reshape(nx, ny, nz, 3)
