"""The reference's default scenario (port of ``fusion_sim_tpu/scenarios.py``).

``default_scenario_arrays`` builds the default scenario of
fusionsim.js:69-148: a wall sink mask (absorb at r_max for all z, and at
the z walls for r-rows 1..nr-2 — the on-axis row is kept,
fusionsim.js:103-112), a box source PDF (r-cells [0, nr/8), the central z
band), particles uniform in a cube near the axis at mid-height, and the
opposed mirror/cusp coil pair.  The arrays come from numpy with the given
seed, so both packages start from the same numbers.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SPEC = {
    # fusionsim.js:74-83
    "radius": 1.0, "height": 2.0, "nr": 400, "nz": 800, "dt": 2e-9,
    "nparticles": 400, "particle_mass": 1.67e-27, "particle_charge": 1.602e-19,
}


def default_scenario_arrays(spec: dict, seed: int = 0) -> dict:
    """Sink mask, source PDF and initial particle arrays for a spec."""
    nr, nz = int(spec["nr"]), int(spec["nz"])
    n = int(spec["nparticles"]) ** 2
    height = float(spec["height"])

    sink = np.ones((nr, nz), np.float32)
    sink[-1, :] = 0                      # r_max wall, all z
    sink[1:-1, 0] = 0                    # z walls, r-rows 1..nr-2
    sink[1:-1, -1] = 0

    source = np.zeros((nr, nz), np.float32)
    source[: max(1, nr // 8), 7 * nz // 16: 9 * nz // 16] = 1.0

    rng = np.random.default_rng(seed)
    position = 0.2 * (rng.random((n, 3)) - 0.5) + np.array([0, 0, height / 2])
    velocity = 0.002 * (rng.random((n, 3)) - 0.5)
    return {"position": position, "velocity": velocity,
            "sink_mask": sink, "source_pdf": source}


def apply_default_scenario(sim, seed: int = 0) -> None:
    """set() + coils + precalc on a CylindricalParticlePusher
    (fusionsim.js:130-148)."""
    spec = sim.spec
    sim.set(default_scenario_arrays({
        "nr": spec.nr, "nz": spec.nz, "nparticles": spec.nparticles,
        "height": spec.height}, seed=seed))
    sim.add_current_loop(0.8 * spec.radius, spec.height, -1e7)
    sim.add_current_loop(0.8 * spec.radius, 0.0, 1e7)
    sim.precalc()
