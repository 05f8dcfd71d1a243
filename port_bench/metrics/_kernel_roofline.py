"""Shared by the ``<kernel>_roofline`` readers: the kernel's least time
(``rooflines/<kernel>.py``, real particles and grid cells) over the mean
device time of its launches in the segment, in percent of the peak."""

from .. import peaks


def share(ctx, kernel: str):
    if ctx.config.get("kernel") != kernel:
        return None
    roof = ctx.roofline(kernel)
    times = ctx.trace.kernel_times(roof.KERNEL)
    if not times:
        return None
    least = peaks.least_seconds(*roof.work(ctx.n_particles, ctx.grid_shape))
    return 100.0 * least / (sum(times) / len(times))
