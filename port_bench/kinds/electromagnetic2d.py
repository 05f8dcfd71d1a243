"""Electromagnetic PIC in 2D3V on the tile-sorted layout, rows ordered by
cell inside each tile: ``fusion_sim_torch.models.electromagnetic.
SortedElectromagneticPIC`` on a 2D grid and a ``Tiling2D``.

Its state, its numbers and their meaning are the 3D kind's
(``electromagnetic.py``: ``snapshot``, ``dropped``, ``step_numbers`` with
``count``, ``moments`` and ``fields``; ``end_numbers`` with ``gauss``,
whose CIC charge and divergence take the grid's rank from its shape); the
reference step is ``reference/pic2d3v.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import pic2d3v
from .electromagnetic import (dropped, end_numbers, snapshot,  # noqa: F401
                              step_numbers)


def build(config: dict, layout: dict, pos: np.ndarray, vel: np.ndarray,
          device):
    """The model through its public constructor, from host arrays."""
    from fusion_sim_torch.models.electromagnetic import (
        EMConfig, SortedElectromagneticPIC)
    from fusion_sim_torch.ops.sorted_deposit import Tiling2D

    phys = config["physics"]
    cfg = EMConfig(grid_shape=tuple(phys["grid_shape"]),
                   cell_size=tuple(phys["cell_size"]), dt=phys["dt"],
                   charge=phys["charge"], mass=phys["mass"],
                   c=phys.get("c", 1.0), eps0=phys.get("eps0", 1.0),
                   field_gather=phys["field_gather"])
    t = config["tiling"]
    tiling = Tiling2D(tile_r=t["tile"][0], tile_z=t["tile"][1],
                      block=t["block"], margin=t["margin"])
    return SortedElectromagneticPIC(cfg, pos, vel, tiling=tiling,
                                    device=device,
                                    **config["shell"], **layout["shell"])


def reference_after(config: dict, before: dict,
                    fdtype: torch.dtype = torch.float32) -> dict:
    """The reference's step from a snapshot, as a snapshot (float32)."""
    x1, v1, e1, b1 = pic2d3v.em_step(config["physics"], before["x"],
                                     before["v"], before["e"], before["b"],
                                     fdtype)
    return {"x": x1, "v": v1.float(), "e": e1.float(), "b": b1.float()}
