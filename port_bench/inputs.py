"""The common generator of the benchmark's plasmas: a traffic file's
parameters and ``--seed`` give the particles' positions and velocities.

A kind that needs another load (``port_bench/kinds/<model>.py``)
defines ``inputs(config, traffic, seed, device)`` with the signature of
``make``, and the harness draws from it at set-up and again for the
reference.  Every load, this one and a kind's, keeps to one contract:

- ``x`` is (N, d) float32 on ``device``, in the grid frame that
  ``check.moments`` reads: grid units, each axis in [0, n) over
  ``grid_shape``;
- ``v`` is (N, ``velocity_components``) float32 on ``device``;
- the draws come from ``--seed`` alone (no other state, no clock), so a
  seed gives the same load again, and every seed the same sizes.

A traffic file (``port_bench/traffic/<name>.json``) holds:

- ``layout``: which of the configuration's layout settings the cell runs
  (``resort`` or ``repair``);
- ``populations``: a list of ``{"share", "v_thermal", "drift"}``, each a
  Maxwellian of standard deviation ``v_thermal`` per velocity component
  about the ``drift`` vector (default zero), taking ``share`` of the
  particles in order (the shares sum to 1);
- ``clump`` (optional): ``{"share", "extent"}``, that share of the
  particles placed in the box of ``extent`` times each axis at the origin,
  the rest uniform over the grid.

``make`` draws from one ``torch.Generator`` on the given device, seeded
with ``--seed`` modulo 2**64, in a fixed order.

No traffic file uses ``drift``, ``clump`` or a second population yet, and
only the CPU tests draw them: they are here so that the mixes kept for
later (a hot plasma, counter-streaming beams, a clumped plasma) come as
data files alone.
"""

from __future__ import annotations

import torch


def make(config: dict, traffic: dict, seed: int, device
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(positions (N, d), velocities (N, v))`` in float32 on ``device``."""
    n = int(config["n_particles"])
    shape = tuple(config["physics"]["grid_shape"])
    vdim = int(config["velocity_components"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    extent = torch.tensor(shape, dtype=torch.float32, device=device)
    pos = torch.rand((n, len(shape)), generator=g, device=device)
    clump = traffic.get("clump")
    if clump:
        k = int(round(clump["share"] * n))
        pos[:k] *= float(clump["extent"])
    pos = torch.remainder(pos * extent, extent)
    vel = torch.randn((n, vdim), generator=g, device=device)
    lo = 0
    pops = traffic["populations"]
    for i, pop in enumerate(pops):
        hi = n if i == len(pops) - 1 else lo + int(round(pop["share"] * n))
        vel[lo:hi] *= float(pop["v_thermal"])
        drift = pop.get("drift")
        if drift:
            vel[lo:hi] += torch.tensor(drift, dtype=torch.float32,
                                       device=device)
        lo = hi
    return pos, vel
