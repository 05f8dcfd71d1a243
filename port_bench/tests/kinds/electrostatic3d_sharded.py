"""The sharded 3D electrostatic kind in the CPU tests: its small
configuration and the faults planted in its timed path, the shell's
``step``, the fused 3D substep where the sharded step looks it up, and
the wrap back to global units where the shard counts its overflow."""

import math

from fusion_sim_torch.models import electrostatic_sharded

from . import altered_substep
from .electrostatic import _drifting_substep, _half_substep


def tiny(config: dict) -> dict:
    """A 16 x 32 x 32 slab (2 x 2 x 2 tiles of 8 x 16 x 16) of a 128^3
    grid over 2 pi, the configuration's cell and omega_p kept, with 4
    particles a cell and a warm-up of two resorts."""
    shape = [16, 32, 32]
    n = math.prod(shape) * 4
    d = 2 * math.pi / 128
    vol = math.prod(shape) * d ** 3
    config["physics"].update(grid_shape=shape, cell_size=[d] * 3,
                             charge=-vol / n, mass=vol / n)
    config["n_particles"] = n
    config["shell"]["capacity"] = n
    config["shell"]["migration_buffer"] = 1024
    for layout in config["layouts"].values():
        layout["shell"]["spill_capacity"] = n
        layout["warmup_steps"] = 2 * layout["shell"]["resort_every"]
    return config


def unchanged(monkeypatch):
    """A step that leaves the state as it was."""
    monkeypatch.setattr(electrostatic_sharded.ShardedElectrostaticPIC,
                        "step", lambda self, n=1: None)


def half(monkeypatch):
    monkeypatch.setattr(
        electrostatic_sharded, "fused_es3d_substep",
        _half_substep(electrostatic_sharded.fused_es3d_substep))


def altered(monkeypatch):
    monkeypatch.setattr(
        electrostatic_sharded, "fused_es3d_substep",
        altered_substep(electrostatic_sharded.fused_es3d_substep))


def drifting(monkeypatch):
    """Every velocity pushed by 1e-6 a step (2e-5 of v_th): too little for
    one step's moments, caught by the momentum held since the inputs."""
    monkeypatch.setattr(
        electrostatic_sharded, "fused_es3d_substep",
        _drifting_substep(electrostatic_sharded.fused_es3d_substep))


def overflow(monkeypatch):
    """One row a step counted as lost past the migration buffer, the
    rows themselves kept: only ``overflow`` can catch it."""
    orig = electrostatic_sharded._wrap_and_migrate

    def wrap(*args, **kw):
        x1, velocity, alive, ov, extra = orig(*args, **kw)
        return x1, velocity, alive, ov + 1, extra

    monkeypatch.setattr(electrostatic_sharded, "_wrap_and_migrate", wrap)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "drifting": drifting, "overflow": overflow}
