"""Device time of the periodic resort per step: the operations launched
under the ``resort`` span (the shell's ``_resort``), over every step of
the segment, which holds whole resort cadences."""


def read(ctx):
    t = ctx.trace
    if not t.span_count.get("resort") or not t.device_ops:
        return None
    return 1e3 * t.span_device_s["resort"] / t.steps
