"""The electromagnetic kind in the CPU tests: its small configuration and
the faults planted in its timed path, the shell's ``step`` and the fused
3D substep where the shell looks it up."""

import torch

from fusion_sim_torch.models import electromagnetic

from . import altered_substep


def tiny(config: dict) -> dict:
    """16^3 cells with 4 particles a cell; the physics as configured."""
    cells = 16
    config["physics"]["grid_shape"] = [cells] * 3
    config["n_particles"] = cells ** 3 * 4
    return config


def _half_substep(orig):
    """Half of the rows left out (invalid, position and velocity kept),
    their current made up by doubling the rest's."""
    def substep(*args, **kw):
        args = list(args)
        pos, vel = args[1], args[2]
        keep = torch.arange(pos.shape[0]) < pos.shape[0] // 2
        args[3] = args[3] & keep    # (table, pos, vel, valid, tile_id, ...)
        x1, v1, grid, in_win = orig(*args, **kw)
        x1 = torch.where(keep[:, None], x1, pos)
        v1 = torch.where(keep[:, None], v1, vel)
        return x1, v1, 2.0 * grid, in_win | ~keep
    return substep


def unchanged(monkeypatch):
    """A step that leaves the state as it was."""
    monkeypatch.setattr(electromagnetic.SortedElectromagneticPIC, "step",
                        lambda self, n=1: None)


def half(monkeypatch):
    monkeypatch.setattr(electromagnetic, "fused_em3d_substep",
                        _half_substep(electromagnetic.fused_em3d_substep))


def altered(monkeypatch):
    monkeypatch.setattr(electromagnetic, "fused_em3d_substep",
                        altered_substep(electromagnetic.fused_em3d_substep))


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
