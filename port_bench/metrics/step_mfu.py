"""The whole step's share of the chip's peak: the least time of a step's
necessary work (the configuration's particle kernel and field solve, each
by its roofline file: bytes over the memory rate or f32 operations over
the f32 rate, whichever is longer) over the mean step of the untraced
window (its wall time by the host's clock over its steps).  The traced
segment is not used: the profiler slows host-bound steps.  A kernel
taken off the path leaves its own roofline silent; this share still
bounds the step.  Silent where the traced segment ran nothing on a
device (a run without a card)."""

from .. import peaks


def read(ctx):
    if not ctx.trace.device_ops or ctx.window_wall_s <= 0:
        return None
    least = sum(peaks.least_seconds(*ctx.roofline(part).work(
        ctx.n_particles, ctx.grid_shape)) for part in ctx.config["step_work"])
    return 100.0 * least * ctx.window_steps / ctx.window_wall_s
