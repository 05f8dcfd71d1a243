"""Electrostatic PIC in 3D on the x-slab decomposition:
``fusion_sim_torch.models.electrostatic_sharded.ShardedElectrostaticPIC``
on a ring of ``n_shards`` ranks, here a world of one that
``parallel.mesh.make_mesh(1, ("space",))`` starts (NCCL on the card,
gloo on the CPU), stepped by kernel B5 on the shard's halo-padded
pseudo-grid.

With one shard the slab is the whole periodic box, so the reference is
the ES kind's: ``reference/pic.es_step`` on the configuration's grid.
The shard keeps its rows in global grid units (its kernel's frame, the
pseudo-grid's x shifted by the halo, lives only inside a step), so
``snapshot`` reads the alive rows as they are, shifted by the slab's
origin (0 on a ring of one), and the carried charge, whose apron the
shard has already folded onto its slab.  The numbers are ES's
(``count``, ``dropped``, ``nonfinite``, ``start``, ``moments``, ``rho``,
``charge``, ``momentum``) and ``overflow``: the shard's count of rows
lost past the migration buffer or past its layout's capacity, which has
to stay 0.  ``dropped`` is the shell's ``spill_dropped``, read from its
host copy where the shell keeps one.
"""

from __future__ import annotations

import atexit

import numpy as np
import torch

from .electrostatic import (end_numbers as _es_end_numbers,  # noqa: F401
                            reference_after, step_numbers)


def _world(device):
    """The ring's mesh: a world of one, started here if none is; the world
    this starts is closed at exit."""
    import torch.distributed as dist

    from fusion_sim_torch.parallel.mesh import make_mesh

    started = not dist.is_initialized()
    mesh = make_mesh(1, ("space",), device=device)
    if started:
        atexit.register(lambda: dist.is_initialized()
                        and dist.destroy_process_group())
    return mesh


def build(config: dict, layout: dict, pos: np.ndarray, vel: np.ndarray,
          device):
    """The shell through its public constructor on the world of one, from
    host arrays."""
    from fusion_sim_torch.models.electrostatic import ESConfig
    from fusion_sim_torch.models.electrostatic_sharded import (
        ShardedElectrostaticPIC, ShardedESConfig)
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D

    phys = config["physics"]
    base = ESConfig(grid_shape=tuple(phys["grid_shape"]),
                    cell_size=tuple(phys["cell_size"]), dt=phys["dt"],
                    charge=phys["charge"], mass=phys["mass"],
                    eps0=phys.get("eps0", 1.0))
    t = config["tiling"]
    cfg = ShardedESConfig(base=base, tiling=Tiling3D(
        tile=tuple(t["tile"]), block=t["block"], margin=t["margin"]),
        **config["shell"], **layout["shell"])
    return ShardedElectrostaticPIC(cfg, _world(device), pos, vel,
                                   device=device)


def snapshot(sim) -> dict:
    """The alive rows in the grid frame, the carried charge (the slab's,
    apron folded) and the overflow count, copied."""
    s = sim.state
    x = s.position[s.alive]
    x_lo = sim._ring.x_lo
    if x_lo:
        x[:, 0] += float(x_lo)
    return {"x": x, "v": s.velocity[s.alive], "rho": s.rho.clone(),
            "overflow": s.overflow.sum()}


def dropped(sim) -> int:
    n = getattr(sim, "rows_dropped", None)
    return int(sim.state.spill_dropped.sum()) if n is None else int(n)


def end_numbers(config: dict, end: dict, x_in: torch.Tensor,
                v_in: torch.Tensor) -> dict[str, float]:
    """ES's, and the program's ``overflow`` (a reference's snapshot, which
    has none, gives none)."""
    out = _es_end_numbers(config, end, x_in, v_in)
    if "overflow" in end:
        out["overflow"] = float(end["overflow"])
    return out
