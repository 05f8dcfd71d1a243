"""The app's ``density()`` on the pusher's rows: each real row's position
and velocity read once (24 B); the moment grid (4 f32 a cell) written,
the moments' average read and written (2 x 16 B), B read for the |B|
layer (12 B) and the RGB frame written (12 B), once a cell.  Operations:
the 11 x 11 bell splat of 4 channels (a multiply and an add each, 968)
for each row or for each cell, whichever are fewer, and per cell the
normalization, the average and the frame (40)."""

import math

BYTES_PER_PARTICLE = 24
BYTES_PER_CELL = 16 + 2 * 16 + 12 + 12
SPLAT_FLOPS = 11 * 11 * 4 * 2
FLOPS_PER_CELL = 40


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = math.prod(grid_shape)
    return (n_particles * BYTES_PER_PARTICLE + cells * BYTES_PER_CELL,
            SPLAT_FLOPS * min(n_particles, cells) + FLOPS_PER_CELL * cells)
