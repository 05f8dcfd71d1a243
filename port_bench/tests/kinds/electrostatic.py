"""The electrostatic kind in the CPU tests: its small configuration and
the faults planted in its timed path, the shell's ``step`` and the fused
2D substep where the shell looks it up."""

import math

import torch

from fusion_sim_torch.models import electrostatic

from . import altered_substep


def tiny(config: dict) -> dict:
    """64^2 cells over 2 pi with 8 particles a cell, omega_p kept at 1."""
    cells, length = 64, 2 * math.pi
    n = cells * cells * 8
    d = length / cells
    config["physics"].update(grid_shape=[cells, cells], cell_size=[d, d],
                             charge=-length ** 2 / n, mass=length ** 2 / n)
    config["n_particles"] = n
    return config


def _half_substep(orig):
    """Half of the rows left out (weight 0, position and velocity kept),
    their charge made up by doubling the rest's."""
    def substep(*args, **kw):
        args = list(args)
        pos, vel = args[1], args[2]
        keep = torch.arange(pos.shape[0]) < pos.shape[0] // 2
        args[3] = torch.where(keep, args[3], 0.0)  # (e_grid, pos, vel, w, ..)
        x1, v1, grid, in_win = orig(*args, **kw)
        x1 = torch.where(keep[:, None], x1, pos)
        v1 = torch.where(keep[:, None], v1, vel)
        return x1, v1, 2.0 * grid, in_win | ~keep
    return substep


def _drifting_substep(orig):
    def substep(*args, **kw):
        x1, v1, grid, in_win = orig(*args, **kw)
        return x1, v1 + 1e-6, grid, in_win
    return substep


def unchanged(monkeypatch):
    """A step that leaves the state as it was."""
    monkeypatch.setattr(electrostatic.SortedElectrostaticPIC, "step",
                        lambda self, n=1: None)


def half(monkeypatch):
    monkeypatch.setattr(electrostatic, "fused_es2d_substep",
                        _half_substep(electrostatic.fused_es2d_substep))


def altered(monkeypatch):
    monkeypatch.setattr(electrostatic, "fused_es2d_substep",
                        altered_substep(electrostatic.fused_es2d_substep))


def drifting(monkeypatch):
    """Every velocity pushed by 1e-6 a step (2e-5 of v_th): too little for
    one step's moments, caught by the momentum held since the inputs."""
    monkeypatch.setattr(electrostatic, "fused_es2d_substep",
                        _drifting_substep(electrostatic.fused_es2d_substep))


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "drifting": drifting}
