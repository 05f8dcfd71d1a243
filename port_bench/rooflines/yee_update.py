"""The electromagnetic field update (B half step, E full step with J, B
half step): E, B and J read once and E, B written once (3 f32 a cell
each); three curls of 12 operations a cell and their updates (6 a
cell each)."""

import math


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = math.prod(grid_shape)
    return cells * 5 * 12, cells * 3 * (12 + 6)
