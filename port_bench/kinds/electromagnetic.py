"""Electromagnetic PIC (3D3V) on the tile-sorted layout:
``fusion_sim_torch.models.electromagnetic.SortedElectromagneticPIC``.

Numbers that decide ``correct`` beside the common ones (``check.py``):

- ``fields``: a checked step's change of E and of B (new minus old,
  which holds the step's current), against the reference's change from
  the same old fields;
- ``gauss``: at the window's end, max |div E - (rho(x_end) -
  rho(x_inputs)) / eps0| over max |rho(x_end)|, rho the reference's CIC
  charge.  Esirkepov's current keeps div E - rho constant, so this holds
  every deposit of every step since the start to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import check
from ..reference import pic


def build(config: dict, layout: dict, pos: np.ndarray, vel: np.ndarray,
          device):
    """The model through its public constructor, from host arrays."""
    from fusion_sim_torch.models.electromagnetic import (
        EMConfig, SortedElectromagneticPIC)
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D

    phys = config["physics"]
    cfg = EMConfig(grid_shape=tuple(phys["grid_shape"]),
                   cell_size=tuple(phys["cell_size"]), dt=phys["dt"],
                   charge=phys["charge"], mass=phys["mass"],
                   c=phys.get("c", 1.0), eps0=phys.get("eps0", 1.0),
                   field_gather=phys["field_gather"])
    t = config["tiling"]
    tiling = Tiling3D(tile=tuple(t["tile"]), block=t["block"],
                      margin=t["margin"])
    return SortedElectromagneticPIC(cfg, pos, vel, tiling=tiling,
                                    device=device,
                                    **config["shell"], **layout["shell"])


def snapshot(sim) -> dict:
    """The real rows and the fields, copied."""
    s = sim.state
    return {"x": s.position[s.valid], "v": s.velocity[s.valid],
            "e": s.e.clone(), "b": s.b.clone()}


def dropped(sim) -> int:
    return int(sim.state.spill_dropped)


def reference_after(config: dict, before: dict,
                    fdtype: torch.dtype = torch.float32) -> dict:
    """The reference's step from a snapshot, as a snapshot (float32)."""
    x1, v1, e1, b1 = pic.em_step(config["physics"], before["x"], before["v"],
                                 before["e"], before["b"], fdtype)
    return {"x": x1, "v": v1.float(), "e": e1.float(), "b": b1.float()}


def step_numbers(config: dict, after: dict, ref: dict,
                 before: dict) -> dict[str, float]:
    shape = tuple(config["physics"]["grid_shape"])
    out = check.rows_gap(after, ref["x"], ref["v"], shape,
                         int(config["n_particles"]))
    out["fields"] = max(
        check.gap(after[k] - before[k], ref[k] - before[k]) for k in "eb")
    return out


def end_numbers(config: dict, end: dict, x_in: torch.Tensor,
                v_in: torch.Tensor) -> dict[str, float]:
    phys = config["physics"]
    shape, dx = tuple(phys["grid_shape"]), tuple(phys["cell_size"])
    w = phys["charge"] / math.prod(dx)

    def rho(x):
        return pic.deposit(x, torch.full((x.shape[0],), w, device=x.device),
                           shape)

    rho_end = rho(end["x"])
    res = pic.yee_divergence(end["e"], dx) - (rho_end - rho(x_in)) / phys.get(
        "eps0", 1.0)
    return {"gauss": float(res.abs().max() / rho_end.abs().max())}
