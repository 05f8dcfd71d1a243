"""``device_idle_pct`` in the device-bound cells, which move
``particle_updates_per_s.device_bound``."""

from .device_idle_pct import read  # noqa: F401
