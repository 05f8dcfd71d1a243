"""Device operations (kernels, copies, sets) in the traced segment, per
step: what the shell asks of the device each step."""


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    return ctx.trace.device_ops / ctx.trace.steps
