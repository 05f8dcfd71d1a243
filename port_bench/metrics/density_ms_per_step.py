"""Device time a step of the app's ``density()``: the operations launched
under the pusher's ``fusion_sim.density`` span (the moment deposit and
its bell convolution, the normalization, the average and the frame)."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "density")
