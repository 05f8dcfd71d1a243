"""Kernel B5, the fused 3D electrostatic substep (``es3d_substep_kernel``):
per real particle it gathers E (CIC, 3 components at 8 corners), kicks,
drifts and deposits its charge (CIC) at the new position.

Bytes, counted once per real particle and per grid cell, whatever rows
of padding the layout adds: position and velocity (3 f32 each) read and
written (4 x 12 B); the E grid (3 f32 a cell) read and the charge grid
(1 f32 a cell) written.

Operations per particle (f32), as ``csrc/es3d_substep.cu`` computes
them: gather 22 (floor, fraction and its complement per axis, 6 a
axis; the 4 y-z corner products) plus 51 (3 components x 2 x-planes, 4
multiplies and 3 adds each; the x blend, 3 x 3); kick 6; drift and wrap
12 (the window's local frame, the drift, back to the grid); deposit 26
(the corner weights at the new position, 6 a axis; the 4 y-z products
and their scale by the charge) plus 16 (8 corner values, an add of each
into the window): 133.  Bytes bound it: 0.440 ms against 0.060 ms of
operations at 29,997,056 particles on 128^3."""

KERNEL = "es3d_substep_kernel"
BYTES_PER_PARTICLE = 4 * 12
BYTES_PER_CELL = 3 * 4 + 4
FLOPS_PER_PARTICLE = 22 + 51 + 6 + 12 + 26 + 16


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = 1
    for n in grid_shape:
        cells *= n
    return (n_particles * BYTES_PER_PARTICLE + cells * BYTES_PER_CELL,
            n_particles * FLOPS_PER_PARTICLE)
