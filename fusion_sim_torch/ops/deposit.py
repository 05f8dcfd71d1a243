"""Particle -> grid moment deposition (port of
``fusion_sim_tpu/ops/deposit.py``).

``programMoments01`` (empic.js:980-1035) rasterizes each particle as an
11x11 point sprite at (r*nr, z*nz), splatting ``0.001 * (vr, va, vz, 1)``
times a cos^2 radial bell (normalized to sum 1).  Every sprite is the same
pixel-aligned stencil, so the splat is exactly

    moments = conv2d(scatter_add(point masses at the nearest cell), bell)

one ``index_add_`` and one f32 convolution with SAME padding (TF32 off).
``normalize_moments`` and ``ema_moments`` mirror empic.js:1042-1084.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SHAPE_SIZE = 11  # empic.js:949 — nshape


def bell_kernel(nshape: int = SHAPE_SIZE, device=None) -> torch.Tensor:
    """The cos^2 radial bell of empic.js:956-971, normalized to sum 1
    (built in float64, stored as f32)."""
    mid = (nshape - 1) / 2
    i = np.arange(nshape)[:, None]
    j = np.arange(nshape)[None, :]
    d = np.sqrt((i - mid) ** 2 + (j - mid) ** 2)
    shape = np.maximum(0.0, np.cos(0.5 * np.pi * d / mid)) ** 2
    shape = shape / shape.sum()
    return torch.tensor(shape, dtype=torch.float32, device=device)


def particle_cell_indices(position: torch.Tensor, nr: int, nz: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest grid cell (ir, iz) int64 and r per particle: the sprite sits
    at window coordinate (r*nr, z*nz) (empic.js:997), covering the pixel
    floor(r*nr), floor(z*nz), clamped to the grid."""
    x, y, z = position[..., 0], position[..., 1], position[..., 2]
    r = torch.sqrt(x * x + y * y)
    ir = torch.clamp(torch.floor(r * nr).to(torch.int64), 0, nr - 1)
    iz = torch.clamp(torch.floor(z * nz).to(torch.int64), 0, nz - 1)
    return ir, iz, r


def deposit_moments(position: torch.Tensor, velocity: torch.Tensor,
                    nr: int, nz: int,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """Deposit (sum vr*w, sum va*w, sum vz*w, sum w) onto the grid; the
    per-particle colour is ``0.001 * (vr, va, vz, 1)`` (empic.js:1008) in
    the cylindrical frame.  ``weights`` (N,) multiplies it (the padded
    sorted layout passes 0 on filler rows).  Returns (nr, nz, 4)."""
    ir, iz, r = particle_cell_indices(position, nr, nz)
    x, y = position[..., 0], position[..., 1]
    dir_x = x / r
    dir_y = y / r
    vx, vy, vz = velocity[..., 0], velocity[..., 1], velocity[..., 2]
    vr = vx * dir_x + vy * dir_y
    va = vy * dir_x - vx * dir_y
    color = 0.001 * torch.stack([vr, va, vz, torch.ones_like(vr)], dim=-1)
    if weights is not None:
        color = color * weights[:, None]
    point_grid = torch.zeros((nr * nz, 4), dtype=torch.float32,
                             device=position.device)
    point_grid.index_add_(0, ir * nz + iz, color)
    point_grid = point_grid.reshape(nr, nz, 4).permute(2, 0, 1)[:, None]
    kernel = bell_kernel(device=position.device)[None, None]
    pad = SHAPE_SIZE // 2
    # full f32 on the card: cuDNN would otherwise convolve in TF32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(point_grid, kernel, padding=pad)
    return out[:, 0].permute(1, 2, 0)


def normalize_moments(moments: torch.Tensor) -> torch.Tensor:
    """Mean velocity and cylindrical volume weighting
    (``programNormalizeMoments01``, empic.js:1048-1060):
    M = (a > 0) ? (rgb/a, a) : 0, times 1000 * 0.5 / u with u the
    texel-centre r coordinate."""
    nr = moments.shape[0]
    a = moments[..., 3:4]
    safe = torch.where(a > 0.0, a, 1.0)
    m = torch.where(a > 0.0, torch.cat([moments[..., :3] / safe, a], dim=-1),
                    0.0)
    u = (torch.arange(nr, dtype=torch.float32,
                      device=moments.device)[:, None, None] + 0.5) / nr
    return 1000.0 * m * 0.5 / u


def ema_moments(next_moments: torch.Tensor, avg: torch.Tensor,
                ratio: float = 0.01) -> torch.Tensor:
    """Exponential moving average (``avg_frag``, empic.js:262-282; ratio
    0.01 per empic.js:1083), in f32."""
    ratio = torch.tensor(ratio, dtype=torch.float32)
    return ratio * next_moments + (1.0 - ratio) * avg
