"""``patch_ms_per_step`` in the device-bound cell that patches a share of
its rows every step (the sharded slab), which moves
``particle_updates_per_s.device_bound``."""

from .patch_ms_per_step import read  # noqa: F401
