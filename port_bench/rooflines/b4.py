"""Kernel B4, the fused 2D3V electromagnetic substep
(``em2d_substep_kernel``): per real particle it gathers the six field
components from the node table (CIC), applies the Boris kick, drifts x
and y and deposits its Esirkepov current, J_z included.

Bytes, counted once per real particle and per grid cell, whatever rows
of padding the layout adds: position (2 f32) and velocity (3 f32) read
and written (2 x 20 B); the node table (6 f32 a cell) read and the
current (3 f32 a cell) written.

Operations per particle (f32), a lower count of the scheme's work:
gather 10 (floor, fraction, complement per axis; 4 corner weights) plus
48 (6 channels x 4 corners, a multiply and an add); Boris 51; drift 4;
Esirkepov: stencil bases 4, the 3-node shapes of both positions 60 (5 a
node), their differences 6; J_x and J_y each 30 (the 3-node factor S0 +
dS / 2, 6; its 3 x 3 product with dS, 9; the running sum, 6; the scale,
9); J_z 50 (two 3-node factors in x, 12; the 3 x 3 mix as two products
and an add, 27; the scale by q v_z / V, 11); total 293, taken as 270 for
the branches that real stencils skip.  Bytes bound it: 0.122 ms against
0.040 ms of operations at 10M particles on 512^2."""

KERNEL = "em2d_substep_kernel"
BYTES_PER_PARTICLE = 2 * 20
BYTES_PER_CELL = 6 * 4 + 3 * 4
FLOPS_PER_PARTICLE = 270


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = 1
    for n in grid_shape:
        cells *= n
    return (n_particles * BYTES_PER_PARTICLE + cells * BYTES_PER_CELL,
            n_particles * FLOPS_PER_PARTICLE)
