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
