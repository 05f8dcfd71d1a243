"""Figure compositing, 2D field plots, colorbars and the animation loop
(port of ``fusion_sim_tpu/utils/figure.py``).

Counterparts of the reference's plotting toolkit (utilities.js:1319-1994,
U12-U15 in SURVEY.md; unused by the live fusion-sim path):

* ``Plot2DArea`` — colormapped blit of a scalar field into a figure region
  (``makePlot2DArea``, utilities.js:1319-1422).
* ``ColorBar`` — vertical colormap legend (``makeColorBar``,
  utilities.js:1436-1494).
* ``CanvasFigure`` — layered compositor with mouse-selection hit-testing
  incl. ctrl-multiselect (``makeCanvasFigure``/``makeSquareClickArea``/
  ``makeImageClickArea``, utilities.js:1497-1841).
* ``Animation`` — frame loop over figures with duration and a 1-second FPS
  callback window (``makeAnimation``, utilities.js:1846-1994).

The canvas is a uint8 RGB ndarray; a plot maps its field through the
colormap on the field's device and composites on the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from .colormaps import ColorMap


@dataclasses.dataclass
class Plot2DArea:
    """Colormapped scalar-field region of a figure.

    ``source`` is a callable returning the current (h, w) scalar field (or a
    fixed array); drawn through ``colormap`` into the figure at (x, y).
    """

    x: int
    y: int
    width: int
    height: int
    colormap: ColorMap
    source: Callable[[], np.ndarray] | np.ndarray

    def render(self) -> np.ndarray:
        field = self.source() if callable(self.source) else self.source
        rgb = self.colormap.apply(field).cpu().numpy()
        if rgb.shape[:2] != (self.height, self.width):
            # nearest-neighbor resample to the plot area (the reference blits
            # via ImageData at native size; resampling is our generalization)
            sy = np.linspace(0, rgb.shape[0] - 1, self.height).round().astype(int)
            sx = np.linspace(0, rgb.shape[1] - 1, self.width).round().astype(int)
            rgb = rgb[sy][:, sx]
        return rgb


@dataclasses.dataclass
class ColorBar:
    """Vertical colormap legend strip (top = max, like utilities.js:1466)."""

    x: int
    y: int
    width: int
    height: int
    colormap: ColorMap

    def render(self) -> np.ndarray:
        vals = np.linspace(self.colormap.max, self.colormap.min, self.height)
        col = self.colormap.rgb(vals)  # (h, 3)
        return np.broadcast_to(col[:, None, :], (self.height, self.width, 3)).copy()


@dataclasses.dataclass(eq=False)  # identity semantics (hashable selections)
class ClickArea:
    """Rectangular selectable region (makeSquareClickArea semantics)."""

    x: int
    y: int
    width: int
    height: int
    name: str = ""
    selected: bool = False

    def contains(self, px: int, py: int) -> bool:
        return (self.x <= px < self.x + self.width
                and self.y <= py < self.y + self.height)


@dataclasses.dataclass(eq=False)
class ImageClickArea(ClickArea):
    """Image-backed selectable region (the ``makeImageClickArea`` role,
    utilities.js:1785-1841).  The reference hit-tests only the bounding
    rectangle; the optional opacity ``mask`` test here is an extension —
    with ``mask=None`` behavior matches the reference's rectangle test."""

    mask: np.ndarray | None = None     # (h, w) alpha/opacity array
    threshold: float = 0.5

    def contains(self, px: int, py: int) -> bool:
        if not super().contains(px, py):
            return False
        if self.mask is None:
            return True
        my, mx = py - self.y, px - self.x
        if my >= self.mask.shape[0] or mx >= self.mask.shape[1]:
            return False
        return float(self.mask[my, mx]) > self.threshold


class CanvasFigure:
    """Layered figure: render all layers into one uint8 RGB canvas.

    Layers are objects with ``x``, ``y`` and ``render() -> (h, w, 3)``.
    ``click(px, py, ctrl=False)`` reproduces the reference's selection
    semantics (utilities.js:1720-1804): plain click selects exactly the hit
    area (deselecting others), ctrl-click toggles membership.
    """

    def __init__(self, width: int, height: int,
                 background: tuple[int, int, int] = (0, 0, 0)):
        self.width = width
        self.height = height
        self.background = background
        self.layers: list = []
        self.click_areas: list[ClickArea] = []

    def add_layer(self, layer) -> "CanvasFigure":
        self.layers.append(layer)
        return self

    def add_click_area(self, area: ClickArea) -> "CanvasFigure":
        self.click_areas.append(area)
        return self

    def redraw(self) -> np.ndarray:
        canvas = np.empty((self.height, self.width, 3), np.uint8)
        canvas[:] = self.background
        for layer in self.layers:
            img = np.asarray(layer.render(), np.uint8)
            h, w = img.shape[:2]
            y0, x0 = layer.y, layer.x
            y1, x1 = min(y0 + h, self.height), min(x0 + w, self.width)
            if y1 > y0 and x1 > x0:
                canvas[y0:y1, x0:x1] = img[: y1 - y0, : x1 - x0]
        return canvas

    def click(self, px: int, py: int, ctrl: bool = False) -> list[ClickArea]:
        """Returns the currently selected areas after applying the click."""
        hit = next((a for a in self.click_areas if a.contains(px, py)), None)
        if hit is None:
            if not ctrl:
                for a in self.click_areas:
                    a.selected = False
        elif ctrl:
            hit.selected = not hit.selected
        else:
            for a in self.click_areas:
                a.selected = a is hit
        return [a for a in self.click_areas if a.selected]


class Animation:
    """Frame loop across figures with duration + FPS callback.

    The rAF loop of utilities.js:1846-1994 as a plain host loop:
    ``run(frame_fn, duration)`` calls ``frame_fn(t)`` then redraws every
    figure; ``fps_callback`` fires each time a 1-second window closes.
    """

    def __init__(self, figures: list[CanvasFigure],
                 fps_callback: Callable[[float], None] | None = None,
                 max_fps: float | None = None):
        self.figures = figures
        self.fps_callback = fps_callback
        self.max_fps = max_fps
        self.running = False

    def run(self, frame_fn: Callable[[float], None],
            duration: float | None = None,
            max_frames: int | None = None) -> int:
        self.running = True
        start = time.perf_counter()
        win_start = start
        win_frames = 0
        frames = 0
        while self.running:
            t = time.perf_counter() - start
            if duration is not None and t >= duration:
                break
            if max_frames is not None and frames >= max_frames:
                break
            frame_fn(t)
            for fig in self.figures:
                fig.redraw()
            frames += 1
            win_frames += 1
            now = time.perf_counter()
            if now - win_start >= 1.0:
                if self.fps_callback:
                    self.fps_callback(win_frames / (now - win_start))
                win_start = now
                win_frames = 0
            if self.max_fps:
                time.sleep(max(0.0, 1.0 / self.max_fps - (time.perf_counter() - now)))
        self.running = False
        return frames

    def stop(self) -> None:
        self.running = False
