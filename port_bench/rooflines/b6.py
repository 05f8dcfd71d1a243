"""Kernel B6, the fused 3D3V electromagnetic substep
(``em3d_substep_kernel``): per real particle it gathers the six field
components from the node table (CIC), applies the Boris kick, drifts and
deposits its Esirkepov current.

Bytes, counted once per real particle and per grid cell, whatever rows
of padding the layout adds: position and velocity (3 f32 each) read and
written (4 x 12 B); the node table (6 f32 a cell) read and the current
(3 f32 a cell) written.

Operations per particle (f32), a lower count of the scheme's work:
gather 24 (floor, fraction, complement per axis; 8 corner weights as 2
multiplies each) plus 96 (6 channels x 8 corners, a multiply and an add);
Boris 51; drift 9; Esirkepov: stencil bases 6, the 3-node shapes of both
positions 90 (5 a node), their differences 9, and per current component
the 3 x 3 mix 81, its product with dS 27, the running sum 18 and the
scale 27 (x 3 = 459); total 745, taken as 700 for the branches that real
stencils skip."""

KERNEL = "em3d_substep_kernel"
BYTES_PER_PARTICLE = 4 * 12
BYTES_PER_CELL = 6 * 4 + 3 * 4
FLOPS_PER_PARTICLE = 700


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = 1
    for n in grid_shape:
        cells *= n
    return (n_particles * BYTES_PER_PARTICLE + cells * BYTES_PER_CELL,
            n_particles * FLOPS_PER_PARTICLE)
