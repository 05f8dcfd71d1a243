"""Kernel B1, the fused 2D electrostatic substep (``es2d_substep_kernel``):
per real particle it gathers E (CIC), kicks, drifts and deposits its
charge (CIC) at the new position.

Bytes, counted once per real particle and per grid cell, whatever rows
of padding the layout adds: position and velocity read (2 x 8 B) and
written (2 x 8 B); the E grid (2 f32 a cell) read and the charge grid
(1 f32 a cell) written.

Operations per particle (f32): gather 10 (floor, fraction and its
complement per axis, 4 corner weights) plus 16 (2 components x 4
corners, a multiply and an add each); kick 4; drift and wrap 8; deposit
10 (corner weights again) plus 8 (the charge times each corner weight,
an add into the grid each): 56."""

KERNEL = "es2d_substep_kernel"
BYTES_PER_PARTICLE = 2 * 8 + 2 * 8
BYTES_PER_CELL = 2 * 4 + 4
FLOPS_PER_PARTICLE = 10 + 16 + 4 + 8 + 10 + 8


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = 1
    for n in grid_shape:
        cells *= n
    return (n_particles * BYTES_PER_PARTICLE + cells * BYTES_PER_CELL,
            n_particles * FLOPS_PER_PARTICLE)
