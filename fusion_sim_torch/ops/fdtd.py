"""Yee-grid FDTD field updates (2D and 3D, periodic).

Port of ``fusion_sim_tpu/ops/fdtd.py``: the staggered Yee scheme written
as rolls and differences (``torch.roll`` follows ``jnp.roll``).

Staggering (2D, cell (i, j), periodic; "2D3V" = 2D space, 3 velocity/field
components):

    Ex(i+1/2, j)   Ey(i, j+1/2)   Ez(i, j)
    Bx(i, j+1/2)   By(i+1/2, j)   Bz(i+1/2, j+1/2)

3D uses the canonical Yee cube: E components on edge centers, B on face
centers.  Time integration is the leapfrog B(half) -> E(full) -> B(half)
split so both fields are available at integer steps for the particle push.

Fields are packed with a trailing component axis: ``e[..., 0:3] = (Ex, Ey,
Ez)``, ``b[..., 0:3] = (Bx, By, Bz)``.  Units: natural (c = eps0 = mu0 = 1)
by default; pass ``c``/``eps0`` to rescale.  Differences divide by the cell
size (no multiply by a reciprocal), as the reference does, so fields agree
with it to rounding over many steps.
"""

from __future__ import annotations

import torch

from .interp import cic_gather_packed


def _d_plus(f: torch.Tensor, axis: int, d: float) -> torch.Tensor:
    """Forward difference (f[i+1]-f[i])/d with periodic wrap."""
    return (torch.roll(f, -1, axis) - f) / d


def _d_minus(f: torch.Tensor, axis: int, d: float) -> torch.Tensor:
    """Backward difference (f[i]-f[i-1])/d with periodic wrap."""
    return (f - torch.roll(f, 1, axis)) / d


def curl_e_2d(e: torch.Tensor, dx: tuple[float, float]) -> torch.Tensor:
    """(curl E) evaluated at the B staggering points (2D3V)."""
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    # Bx(i, j+1/2):      (curl E)_x = dEz/dy
    cx = _d_plus(ez, 1, dx[1])
    # By(i+1/2, j):      (curl E)_y = -dEz/dx
    cy = -_d_plus(ez, 0, dx[0])
    # Bz(i+1/2, j+1/2):  (curl E)_z = dEy/dx - dEx/dy
    cz = _d_plus(ey, 0, dx[0]) - _d_plus(ex, 1, dx[1])
    return torch.stack([cx, cy, cz], dim=-1)


def curl_b_2d(b: torch.Tensor, dx: tuple[float, float]) -> torch.Tensor:
    """(curl B) evaluated at the E staggering points (2D3V)."""
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    # Ex(i+1/2, j):  (curl B)_x = dBz/dy
    cx = _d_minus(bz, 1, dx[1])
    # Ey(i, j+1/2):  (curl B)_y = -dBz/dx
    cy = -_d_minus(bz, 0, dx[0])
    # Ez(i, j):      (curl B)_z = dBy/dx - dBx/dy
    cz = _d_minus(by, 0, dx[0]) - _d_minus(bx, 1, dx[1])
    return torch.stack([cx, cy, cz], dim=-1)


def curl_e_3d(e: torch.Tensor, dx: tuple[float, float, float]
              ) -> torch.Tensor:
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    cx = _d_plus(ez, 1, dx[1]) - _d_plus(ey, 2, dx[2])
    cy = _d_plus(ex, 2, dx[2]) - _d_plus(ez, 0, dx[0])
    cz = _d_plus(ey, 0, dx[0]) - _d_plus(ex, 1, dx[1])
    return torch.stack([cx, cy, cz], dim=-1)


def curl_b_3d(b: torch.Tensor, dx: tuple[float, float, float]
              ) -> torch.Tensor:
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    cx = _d_minus(bz, 1, dx[1]) - _d_minus(by, 2, dx[2])
    cy = _d_minus(bx, 2, dx[2]) - _d_minus(bz, 0, dx[0])
    cz = _d_minus(by, 0, dx[0]) - _d_minus(bx, 1, dx[1])
    return torch.stack([cx, cy, cz], dim=-1)


def curl_e(e: torch.Tensor, dx: tuple[float, ...]) -> torch.Tensor:
    return curl_e_2d(e, dx) if len(dx) == 2 else curl_e_3d(e, dx)


def curl_b(b: torch.Tensor, dx: tuple[float, ...]) -> torch.Tensor:
    return curl_b_2d(b, dx) if len(dx) == 2 else curl_b_3d(b, dx)


def advance_b_half(b: torch.Tensor, e: torch.Tensor, dt: float,
                   dx: tuple[float, ...]) -> torch.Tensor:
    """B -> B - (dt/2) curl E (Faraday half-step)."""
    return b - (0.5 * dt) * curl_e(e, dx)


def advance_e_full(e: torch.Tensor, b: torch.Tensor, j: torch.Tensor,
                   dt: float, dx: tuple[float, ...], c: float = 1.0,
                   eps0: float = 1.0) -> torch.Tensor:
    """E -> E + dt (c^2 curl B - J/eps0) (Ampere full step)."""
    return e + dt * ((c * c) * curl_b(b, dx) - j / eps0)


# Staggering offsets, in grid units, of each field component relative to the
# cell-corner node lattice (gathers shift particle positions by -offset).
E_OFFSETS_2D = ((0.5, 0.0), (0.0, 0.5), (0.0, 0.0))
B_OFFSETS_2D = ((0.0, 0.5), (0.5, 0.0), (0.5, 0.5))
E_OFFSETS_3D = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 0.5))
B_OFFSETS_3D = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))


def center_fields(e: torch.Tensor, b: torch.Tensor, e_offsets,
                  b_offsets) -> torch.Tensor:
    """Average staggered E and B components to the nodes.

    A component stored at offset +1/2 along an axis is averaged with its
    rolled neighbor to land on the node.  Returns a packed, contiguous
    (*grid, 6) table (Ex, Ey, Ez, Bx, By, Bz) for the single-gather
    'centered' particle push."""
    cols = []
    for field, offsets in ((e, e_offsets), (b, b_offsets)):
        for comp, off in enumerate(offsets):
            c = field[..., comp]
            for axis, o in enumerate(off):
                if o:
                    # array index i holds the value at i+1/2; the node-i
                    # average is (value at i-1/2 + value at i+1/2)/2
                    c = 0.5 * (c + torch.roll(c, 1, axis))
            cols.append(c)
    return torch.stack(cols, dim=-1)


def gather_staggered(field: torch.Tensor, position: torch.Tensor,
                     offsets, shape: tuple[int, ...]) -> torch.Tensor:
    """CIC-gather each staggered component at particle positions.

    ``field``: (*shape, 3); ``position``: (N, d) grid units.  Component c
    is sampled on its own staggered lattice by shifting the particle
    coordinate by -offset[c].  Returns (N, 3)."""
    grid = torch.tensor(shape, dtype=torch.float32, device=position.device)
    cols = []
    for comp, off in enumerate(offsets):
        shift = torch.tensor(off, dtype=torch.float32,
                             device=position.device)
        shifted = torch.remainder(position - shift, grid)
        cols.append(cic_gather_packed(field[..., comp], shifted, shape))
    return torch.stack(cols, dim=-1)
