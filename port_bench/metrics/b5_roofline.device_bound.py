"""``b5_roofline`` in the device-bound cell (the sharded slab, whose B5
runs on the shard's halo-padded pseudo-grid; the roofline counts the
slab's real cells, the halo being the decomposition's padding), which
moves ``particle_updates_per_s.device_bound``."""

from .b5_roofline import read  # noqa: F401
