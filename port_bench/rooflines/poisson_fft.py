"""The electrostatic field solve: the charge grid read once, E (one f32
a cell and axis) written once; a forward and an inverse real FFT of
5 n log2(n) / 2 operations each on n cells, plus the k-space scaling and
the central differences (3 operations a cell and axis)."""

import math


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = math.prod(grid_shape)
    dims = len(grid_shape)
    ffts = 2 * 2.5 * cells * math.log2(cells)
    return cells * (4 + 4 * dims), ffts + cells * (1 + 3 * dims)
