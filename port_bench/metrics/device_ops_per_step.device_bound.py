"""``device_ops_per_step`` in the device-bound cells, which move
``particle_updates_per_s.device_bound``."""

from .device_ops_per_step import read  # noqa: F401
