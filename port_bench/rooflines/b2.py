"""Kernel B2, the fused half-step of the tile-sorted cylindrical pusher
(``pusher_substep_kernel``): per row it gathers the 12 Boris coefficients
of its nearest cell, rotates (or re-initializes a fresh row thermally),
drifts and samples the sink of its new cell.  Counted per launch, two a
step.

Bytes, counted once per real particle and per grid cell, whatever rows
of padding the layout adds: position, velocity and alive read (12 + 12 +
4 B), position, velocity, sink and in_win written (12 + 12 + 4 + 1 B),
57 B; the 13-channel table (R1 | R2 | R3 | A and the sink, f32) read
once a cell.  A fresh row reads 12 B of uniforms more; which rows are
fresh is not known here, and they are a few hundredths of a percent of
the rows in a frame, so they are left out: the least time is the lower
for it.

Operations per particle (f32), as ``chip_smoke.py`` counts B2's: 60
(cell and window coordinates, the direction, the rotation's three rows,
the rotation back, the drift and the new cell)."""

KERNEL = "pusher_substep_kernel"
BYTES_PER_PARTICLE = (12 + 12 + 4) + (12 + 12 + 4 + 1)
BYTES_PER_CELL = 13 * 4
FLOPS_PER_PARTICLE = 60


def work(n_particles: int, grid_shape) -> tuple[float, float]:
    cells = 1
    for n in grid_shape:
        cells *= n
    return (n_particles * BYTES_PER_PARTICLE + cells * BYTES_PER_CELL,
            n_particles * FLOPS_PER_PARTICLE)
