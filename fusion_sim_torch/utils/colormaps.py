"""Colormaps, ranges and LUTs for visualization (port of
``fusion_sim_tpu/utils/colormaps.py``).

* ``Range`` — min/max -> [0, 1] affine normalization with clamping
  (``makeRange``, utilities.js:1012-1064).
* ``ColorMap`` — piecewise-linear per-channel maps compiled into n-entry
  uint8 LUTs (``makeColorMap``, utilities.js:1079-1198).  A channel is a
  list of segments ``(x0, x1, y0, y1)``: for x in [x0, x1] the channel is
  the linear blend y0->y1 (later segments overwrite earlier ones, the
  reference's loop order).
* ``PRESETS`` — the 25 preset channel tables of utilities.js:1203-1317.

The LUTs are built in numpy as the reference builds them; ``apply`` maps a
field tensor to RGB on the field's device through a copy of the LUT there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Segment = tuple[float, float, float, float]


@dataclasses.dataclass
class Range:
    """Affine normalization of [min, max] onto [0, 1], clamped."""

    min: float
    max: float

    def norm(self, x):
        slope = 1.0 / (self.max - self.min)
        return np.clip(slope * x - slope * self.min, 0.0, 1.0)

    def norm_device(self, x: torch.Tensor) -> torch.Tensor:
        slope = 1.0 / (self.max - self.min)
        return torch.clamp(slope * x - slope * self.min, 0.0, 1.0)


def _build_channel(segments: list[Segment], n: int) -> np.ndarray:
    """Compile one channel's piecewise-linear segments into an n-entry LUT.

    Matches utilities.js:1106-1143: x = i/(n-1); for every segment containing
    x, the LUT entry is floor(255 * lerp) — later segments win.
    """
    lut = np.zeros(n, dtype=np.uint8)
    x = np.arange(n) / (n - 1)
    for x0, x1, y0, y1 in segments:
        mask = (x >= x0) & (x <= x1)
        s = (x[mask] - x0) / (x1 - x0)
        y = (1 - s) * y0 + s * y1
        lut[mask] = np.floor(255 * y).astype(np.uint8)
    return lut


class ColorMap(Range):
    """A compiled colormap: Range + (n, 3) uint8 LUT."""

    def __init__(self, min: float, max: float, n: int, params: dict):
        super().__init__(min=min, max=max)
        self.n = n
        self.lut = np.stack(
            [_build_channel(params.get(ch, []), n) for ch in ("r", "g", "b")],
            axis=-1)  # (n, 3) uint8
        self._lut_by_device: dict[torch.device, torch.Tensor] = {}

    def rgb(self, x) -> np.ndarray:
        """Scalar(s) -> uint8 RGB via the LUT (host)."""
        idx = np.floor((self.n - 1) * self.norm(x)).astype(np.int64)
        return self.lut[idx]

    def apply(self, field) -> torch.Tensor:
        """Map a scalar field to (..., 3) uint8 RGB on the field's device
        (a numpy field is mapped on the CPU).  The field is taken as f32,
        as the reference takes it."""
        x = torch.as_tensor(field).to(torch.float32)
        lut = self._lut_by_device.get(x.device)
        if lut is None:
            lut = torch.as_tensor(self.lut, device=x.device)
            self._lut_by_device[x.device] = lut
        idx = torch.floor((self.n - 1) * self.norm_device(x)).to(torch.int64)
        return lut[idx]


# The 25 channel tables of utilities.js:1203-1317, verbatim as data.
PRESETS: dict[str, dict[str, list[Segment]]] = {
    "jet": {
        "r": [(0.4, 0.6, 0, 1), (0.6, 0.9, 1, 1), (0.9, 1, 1, 0.5)],
        "g": [(0.1, 0.4, 0, 1), (0.4, 0.6, 1, 1), (0.6, 0.9, 1, 0)],
        "b": [(0, 0.1, 0.5, 1), (0.1, 0.4, 1, 1), (0.4, 0.6, 1, 0)],
    },
    "hot": {
        "r": [(0, 0.35, 0, 1), (0.35, 1, 1, 1)],
        "g": [(0.35, 0.65, 0, 1), (0.65, 1, 1, 1)],
        "b": [(0.65, 1, 0, 1)],
    },
    "rainbow": {
        "r": [(0, 0.2, 1, 1), (0.2, 0.4, 1, 0), (0.8, 1, 0, 1)],
        "g": [(0, 0.2, 0, 1), (0.2, 0.6, 1, 1), (0.6, 0.8, 1, 0)],
        "b": [(0.4, 0.6, 0, 1), (0.6, 1, 1, 1)],
    },
    "gray": {"r": [(0, 1, 0, 1)], "g": [(0, 1, 0, 1)], "b": [(0, 1, 0, 1)]},
    "bone": {
        "r": [(0, 1, 0, 1)],
        "g": [(0, 1, 0, 1)],
        "b": [(0, 0.5, 0, 0.65), (0.5, 1, 0.65, 1)],
    },
    "violet": {
        "r": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
        "g": [(0.5, 1, 0, 1)],
        "b": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
    },
    "yellow": {
        "r": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
        "g": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
        "b": [(0.5, 1, 0, 1)],
    },
    "cyan": {
        "r": [(0.5, 1, 0, 1)],
        "g": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
        "b": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
    },
    "red_violet": {
        "r": [(0, 0.33, 0, 1), (0.33, 1, 1, 1)],
        "g": [(0.66, 1, 0, 1)],
        "b": [(0.33, 0.66, 0, 1), (0.66, 1, 1, 1)],
    },
    "green_cyan": {
        "r": [(0.66, 1, 0, 1)],
        "g": [(0, 0.33, 0, 1), (0.33, 1, 1, 1)],
        "b": [(0.33, 0.66, 0, 1), (0.66, 1, 1, 1)],
    },
    "green": {
        "r": [(0.5, 1, 0, 1)],
        "g": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
        "b": [(0.5, 1, 0, 1)],
    },
    "red": {
        "r": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
        "g": [(0.5, 1, 0, 1)],
        "b": [(0.5, 1, 0, 1)],
    },
    "blue": {
        "r": [(0.5, 1, 0, 1)],
        "g": [(0.5, 1, 0, 1)],
        "b": [(0, 0.5, 0, 1), (0.5, 1, 1, 1)],
    },
    "blue_cyan": {
        "r": [(0.66, 1, 0, 1)],
        "g": [(0.33, 0.66, 0, 1), (0.66, 1, 1, 1)],
        "b": [(0, 0.33, 0, 1), (0.33, 1, 1, 1)],
    },
    "mud": {"r": [(0, 1, 0, 1)], "g": [(0.33, 1, 0, 1)], "b": [(0.66, 1, 0, 1)]},
    "grass": {"r": [(0.33, 1, 0, 1)], "g": [(0, 1, 0, 1)], "b": [(0.66, 1, 0, 1)]},
    "purplehaze": {"r": [(0.33, 1, 0, 1)], "g": [(0.66, 1, 0, 1)], "b": [(0, 1, 0, 1)]},
    "atmosphere": {"r": [(0.66, 1, 0, 1)], "g": [(0.33, 1, 0, 1)], "b": [(0, 1, 0, 1)]},
    "pond": {"r": [(0.66, 1, 0, 1)], "g": [(0, 1, 0, 1)], "b": [(0.33, 1, 0, 1)]},
    "berry": {"r": [(0, 1, 0, 1)], "g": [(0.66, 1, 0, 1)], "b": [(0.33, 1, 0, 1)]},
    "doppler": {
        "r": [(0, 0.5, 1, 1), (0.5, 0.75, 1, 0)],
        "g": [(0, 0.5, 0, 1), (0.5, 1, 1, 0)],
        "b": [(0.25, 0.5, 0, 1), (0.5, 1, 1, 1)],
    },
    "autumn": {"r": [(0, 1, 1, 1)], "g": [(0, 1, 0, 1)], "b": []},
    "spring": {"r": [(0, 1, 1, 1)], "g": [(0, 1, 0, 1)], "b": [(0, 1, 1, 0)]},
    "winter": {"r": [(0, 1, 0, 0.3)], "g": [(0, 1, 0, 1)], "b": [(0, 1, 1, 0.3)]},
    "anime": {
        "r": [(0, 0.33, 0.7, 0.9), (0.33, 0.66, 0.9, 0), (0.95, 1, 0, 1)],
        "g": [(0, 0.33, 0.1, 0.7), (0.33, 0.66, 0.7, 0), (0.66, 1, 0, 1)],
        "b": [(0, 0.33, 0.15, 0.3), (0.33, 0.66, 0.3, 0.7), (0.66, 1, 0.7, 1)],
    },
}


def preset(name: str, min: float = 0.0, max: float = 1.0, n: int = 256) -> ColorMap:
    """Build a ColorMap from a named preset (default 256-entry LUT)."""
    if name not in PRESETS:
        raise KeyError(f"unknown colormap preset {name!r}; have {sorted(PRESETS)}")
    return ColorMap(min=min, max=max, n=n, params=PRESETS[name])
