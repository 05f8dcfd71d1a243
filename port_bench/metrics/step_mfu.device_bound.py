"""``step_mfu`` in the device-bound cells, which move
``particle_updates_per_s.device_bound``."""

from .step_mfu import read  # noqa: F401
