"""Per-substep uniforms (port of ``fusion_sim_tpu/ops/rng.py``).

The reference's WebGL chaotic-map RNG (empic.js:783-895) emits four
uniforms per particle per substep; the JAX package draws them from
threefry.  The port draws them from a ``torch.Generator`` (Philox on the
card), which cannot replay JAX's streams: the two packages agree in
distribution only.  Tests that compare trajectories hand JAX's own draws
to the port's step functions instead.
"""

from __future__ import annotations

import torch


def substep_uniforms(generator: torch.Generator, n_particles: int,
                     device) -> torch.Tensor:
    """This substep's (N, 4) U(0, 1) f32 uniforms from ``generator`` (which
    lives on ``device``): ``[:, :2]`` feed the respawn sampler
    (empic.js:714-716), ``[:, :3]`` the thermal re-init (empic.js:771-772).
    """
    return torch.rand((n_particles, 4), generator=generator,
                      dtype=torch.float32, device=device)


def step_uniforms(generator: torch.Generator, n_particles: int,
                  device) -> torch.Tensor:
    """Both half-steps' uniforms from one draw: (2, N, 4) f32 U(0, 1),
    ``[0]`` for the first substep and ``[1]`` for the second (the
    reference's rand_B/rand_A order, empic.js:1436-1469).  The same
    distribution as two ``substep_uniforms`` calls."""
    return torch.rand((2, n_particles, 4), generator=generator,
                      dtype=torch.float32, device=device)
