"""The pusher kind in the CPU tests: its small configuration and the faults
planted in its timed path, the shell's ``step``, the fused substep, the
respawn and the average where the sorted path looks them up."""

import torch

from fusion_sim_torch.models import pusher, pusher_sorted


def tiny(config: dict) -> dict:
    """16^2 protons on 32 x 64 cells, tiles of 8 x 64 cells (the fused
    path's tiling for that grid) with the margin as configured, and a
    time step 40 times the app's, so that rows reach the walls and
    respawn from the first frames; a short warm-up."""
    config["physics"].update(grid_shape=[32, 64],
                             dt=40 * config["physics"]["dt"])
    config["n_particles"] = 16 * 16
    config["tiling"]["tile"] = [8, 64]
    for layout in config["layouts"].values():
        layout["warmup_steps"] = 30
    return config


def _real(position, velocity):
    """The first row that is no filler (fillers stand still at r = z =
    0.5 with zero velocity)."""
    return int(torch.nonzero(velocity.abs().sum(1) > 0)[0])


def _altered_substep(orig):
    """The first real row's new position moved a quarter cell out in r."""
    def substep(*args, **kw):
        x1, v1, sink, in_win = orig(*args, **kw)
        nr = args[6]
        row = _real(args[1], args[2])
        x1 = x1.clone()
        r = torch.sqrt(x1[row, 0] ** 2 + x1[row, 1] ** 2)
        x1[row, :2] = x1[row, :2] * (1.0 + 0.25 / (nr * r))
        return x1, v1, sink, in_win
    return substep


def _half_substep(orig):
    """The first half of the layout's rows left out: they keep their
    inputs, inside their windows, and are not absorbed."""
    def substep(*args, **kw):
        x1, v1, sink, in_win = orig(*args, **kw)
        pos, vel = args[1], args[2]
        out = torch.arange(pos.shape[0]) < pos.shape[0] // 2
        return (torch.where(out[:, None], pos, x1),
                torch.where(out[:, None], vel, v1),
                torch.where(out, 1.0, sink), in_win | out)
    return substep


def _scaled_substep(orig):
    """Every new velocity scaled by 1 + 5e-6, about 1 + 1e-5 a frame: too
    little for the moments, caught by ``speed``."""
    def substep(*args, **kw):
        x1, v1, sink, in_win = orig(*args, **kw)
        return x1, v1 * (1.0 + 5e-6), sink, in_win
    return substep


def _no_respawn(next_pos, sink, rand, table, respawn_capacity=None):
    """Absorbed rows flagged, but left where they drifted."""
    return next_pos, (sink > 0.5).to(torch.float32), 0


def unchanged(monkeypatch):
    """A step that leaves the rows as they were."""
    monkeypatch.setattr(pusher.CylindricalParticlePusher, "step",
                        lambda self, n=1: None)


def half(monkeypatch):
    monkeypatch.setattr(pusher_sorted, "fused_pusher_substep",
                        _half_substep(pusher_sorted.fused_pusher_substep))


def altered(monkeypatch):
    monkeypatch.setattr(pusher_sorted, "fused_pusher_substep",
                        _altered_substep(pusher_sorted.fused_pusher_substep))


def no_respawn(monkeypatch):
    monkeypatch.setattr(pusher_sorted, "sink_respawn", _no_respawn)


def stale_average(monkeypatch):
    """``density()`` leaves the EMA as it was."""
    monkeypatch.setattr(pusher_sorted, "ema_moments",
                        lambda new, avg, ratio=0.01: avg)


def scaled(monkeypatch):
    monkeypatch.setattr(pusher_sorted, "fused_pusher_substep",
                        _scaled_substep(pusher_sorted.fused_pusher_substep))


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "no_respawn": no_respawn, "stale_average": stale_average,
          "scaled": scaled}
