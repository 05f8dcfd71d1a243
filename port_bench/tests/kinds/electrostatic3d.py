"""The 3D electrostatic kind in the CPU tests: its small configuration and
the faults planted in its timed path, the shell's ``step`` and the fused
3D substep where the shell looks it up."""

import math

from fusion_sim_torch.models import electrostatic

from . import altered_substep
from .electrostatic import _drifting_substep, _half_substep, unchanged


def tiny(config: dict) -> dict:
    """16^3 cells over 2 pi (2 x 2 x 2 tiles of 8^3) with 8 particles a
    cell, omega_p kept at 1, and a warm-up of two resorts."""
    cells, length = 16, 2 * math.pi
    n = cells ** 3 * 8
    d = length / cells
    config["physics"].update(grid_shape=[cells] * 3, cell_size=[d] * 3,
                             charge=-length ** 3 / n, mass=length ** 3 / n)
    config["n_particles"] = n
    for layout in config["layouts"].values():
        layout["warmup_steps"] = 2 * layout["shell"]["resort_every"]
    return config


def half(monkeypatch):
    monkeypatch.setattr(electrostatic, "fused_es3d_substep",
                        _half_substep(electrostatic.fused_es3d_substep))


def altered(monkeypatch):
    monkeypatch.setattr(electrostatic, "fused_es3d_substep",
                        altered_substep(electrostatic.fused_es3d_substep))


def drifting(monkeypatch):
    """Every velocity pushed by 1e-6 a step (2e-5 of v_th): too little for
    one step's moments, caught by the momentum held since the inputs."""
    monkeypatch.setattr(electrostatic, "fused_es3d_substep",
                        _drifting_substep(electrostatic.fused_es3d_substep))


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "drifting": drifting}
