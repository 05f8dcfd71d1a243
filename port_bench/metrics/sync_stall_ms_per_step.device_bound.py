"""Device idle time a step that follows the program's synchronising
calls: the gaps between the union of device intervals, inside the
segment, that hold the end of a call ``syncs_per_step`` counts (the host
waited for the device, then had to launch again), in ms, in the cells
whose pace the device sets."""

from . import _program


def read(ctx):
    seg = _program.segment(ctx)
    if seg is None:
        return None
    return 1e-3 * _program.stall_us(seg) / ctx.trace.steps
