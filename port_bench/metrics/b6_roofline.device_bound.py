"""``b6_roofline`` in the device-bound cells, which move
``particle_updates_per_s.device_bound``."""

from .b6_roofline import read  # noqa: F401
