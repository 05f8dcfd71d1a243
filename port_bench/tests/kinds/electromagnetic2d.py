"""The 2D3V electromagnetic kind in the CPU tests: its small configuration
and the faults planted in its timed path, the shell's ``step`` and the
fused 2D substep where the shell looks it up."""

from fusion_sim_torch.models import electromagnetic

from . import altered_substep
from .electromagnetic import _half_substep, unchanged


def tiny(config: dict) -> dict:
    """64^2 cells (2 x 2 tiles) with 8 particles a cell and a warm-up of
    two resorts; the physics as configured."""
    cells = 64
    config["physics"]["grid_shape"] = [cells] * 2
    config["n_particles"] = cells ** 2 * 8
    for layout in config["layouts"].values():
        layout["warmup_steps"] = 2 * layout["shell"]["resort_every"]
    return config


def _no_jz_substep(orig):
    """The kernel's current without J_z, as if v_z were dropped from its
    deposit; the in-plane current and the rows as computed."""
    def substep(*args, **kw):
        x1, v1, j, in_win = orig(*args, **kw)
        j = j.clone()
        j[..., 2] = 0.0
        return x1, v1, j, in_win
    return substep


def half(monkeypatch):
    monkeypatch.setattr(electromagnetic, "fused_em2d_substep",
                        _half_substep(electromagnetic.fused_em2d_substep))


def altered(monkeypatch):
    monkeypatch.setattr(electromagnetic, "fused_em2d_substep",
                        altered_substep(electromagnetic.fused_em2d_substep))


def no_jz(monkeypatch):
    monkeypatch.setattr(electromagnetic, "fused_em2d_substep",
                        _no_jz_substep(electromagnetic.fused_em2d_substep))


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "no_jz": no_jz}
