"""The share of the traced segment in which no device operation ran: one
minus the union of the device's operation intervals over the segment."""


def read(ctx):
    t = ctx.trace
    if not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
