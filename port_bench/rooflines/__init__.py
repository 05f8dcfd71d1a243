"""Least work of each kernel or solve, one file each: ``work(n_particles,
grid_shape) -> (bytes, f32 operations)``; a kernel's file also names the
``KERNEL`` that the device trace shows."""
