"""Electrostatic PIC on the tile-sorted layout:
``fusion_sim_torch.models.electrostatic.SortedElectrostaticPIC``.

Numbers that decide ``correct`` beside the common ones (``check.py``):

- ``rho``: a checked step's charge at the new positions as the program
  carries it, against the reference's deposit of the reference's new
  positions (the kernel's deposit and the spill patch's);
- ``charge``: at the window's end, |sum of the carried charge x cell
  volume - N q| / (N |q|): every deposit kept.
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
    from fusion_sim_torch.models.electrostatic import (ESConfig,
                                                       SortedElectrostaticPIC)
    from fusion_sim_torch.ops.sorted_deposit import Tiling2D, Tiling3D

    phys = config["physics"]
    cfg = ESConfig(grid_shape=tuple(phys["grid_shape"]),
                   cell_size=tuple(phys["cell_size"]), dt=phys["dt"],
                   charge=phys["charge"], mass=phys["mass"],
                   eps0=phys.get("eps0", 1.0))
    t = config["tiling"]
    if len(t["tile"]) == 2:
        tiling = Tiling2D(tile_r=t["tile"][0], tile_z=t["tile"][1],
                          block=t["block"], margin=t["margin"])
    else:
        tiling = Tiling3D(tile=tuple(t["tile"]), block=t["block"],
                          margin=t["margin"])
    return SortedElectrostaticPIC(cfg, pos, vel, tiling=tiling,
                                  device=device,
                                  **config["shell"], **layout["shell"])


def snapshot(sim) -> dict:
    """The real rows and the carried charge (backend 'pallas'), copied."""
    s = sim.state
    snap = {"x": s.position[s.valid], "v": s.velocity[s.valid]}
    if s.rho is not None:
        snap["rho"] = s.rho.clone()
    return snap


def dropped(sim) -> int:
    return int(sim.state.spill_dropped)


def reference_after(config: dict, before: dict,
                    fdtype: torch.dtype = torch.float32) -> dict:
    """The reference's step from a snapshot, as a snapshot (float32)."""
    x1, v1, rho1 = pic.es_step(config["physics"], before["x"], before["v"],
                               fdtype)
    return {"x": x1, "v": v1.float(), "rho": rho1.float()}


def step_numbers(config: dict, after: dict, ref: dict,
                 before: dict) -> dict[str, float]:
    shape = tuple(config["physics"]["grid_shape"])
    out = check.rows_gap(after, ref["x"], ref["v"], shape,
                         int(config["n_particles"]))
    if "rho" in after:
        out["rho"] = check.gap(after["rho"][..., None],
                               ref["rho"][..., None])
    return out


def end_numbers(config: dict, end: dict, x_in: torch.Tensor,
                v_in: torch.Tensor) -> dict[str, float]:
    phys = config["physics"]
    n = int(config["n_particles"])
    total = float(end["rho"].double().sum()) * math.prod(phys["cell_size"])
    drift = (end["v"].double().sum(0) - v_in.double().sum(0)).abs()
    return {"charge": abs(total - n * phys["charge"]) / (n * abs(
        phys["charge"])),
            "momentum": float((drift / v_in.double().abs().sum(0)).max())}
