"""Device time of the periodic resort per step: the operations launched
under the program's ``fusion_sim.resort`` span (the shell's ``_resort``),
over every step of the segment, which holds whole resort cadences."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "resort")
