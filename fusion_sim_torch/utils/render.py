"""Rendering of fields and particle moments to RGB frames (port of
``fusion_sim_tpu/utils/render.py``).

* ``render_bmag`` — |B| split by direction into RGB (``programBMag``,
  empic.js:467-493): red = |B|*|min(0, dir_z)|, green = |B|*dir_r,
  blue = |B|*max(0, dir_z).
* ``render_density_overlay`` — the density composited on top with the
  reference's SRC_ALPHA, ONE blending (empic.js:1090-1116, :1502-1505):
  the source fragment is 0.5*(a, a, a, 1), so each channel gains 0.25*a.
* ``frame_to_uint8`` — clamp to [0, 1] and quantize for streaming (the
  drawImage analogue, fusionsim.js:176-178), on the frame's device.

Frames are (nr, nz, 3) float RGB, as the reference's ``density`` returns;
``frame_to_uint8`` returns the image layout (nz, nr, 3), z rising upward.
"""

from __future__ import annotations

import torch


def render_bmag(b_field: torch.Tensor) -> torch.Tensor:
    """Magnetic-field background layer: (nr, nz, 3) float RGB in [0, inf)."""
    bx, by, bz = b_field[..., 0], b_field[..., 1], b_field[..., 2]
    mag = torch.sqrt(bx * bx + by * by + bz * bz)
    safe = torch.where(mag > 0.0, mag, 1.0)
    dirs = b_field / safe[..., None]
    red = mag * torch.abs(torch.clamp(dirs[..., 2], max=0.0))
    green = mag * dirs[..., 0]
    blue = mag * torch.clamp(dirs[..., 2], min=0.0)
    return torch.stack([red, green, blue], dim=-1)


def render_density_overlay(background: torch.Tensor,
                           moments_avg: torch.Tensor) -> torch.Tensor:
    """out = 0.25 * a + background (GL blend SRC_ALPHA, ONE with
    src = 0.5*(a, a, a, 1))."""
    a = moments_avg[..., 3]
    return background + ((0.5 * a) * 0.5)[..., None]


def frame_to_uint8(frame: torch.Tensor) -> torch.Tensor:
    """Clamp and quantize an (nr, nz, 3) float frame to image-layout uint8
    on its device: transposed to (nz, nr, 3) and flipped in z so that row 0
    is the top of the canvas.  The caller copies it to the host once."""
    img = (torch.clamp(frame, 0.0, 1.0) * 255.0).to(torch.uint8)
    return img.permute(1, 0, 2).flip(0)
