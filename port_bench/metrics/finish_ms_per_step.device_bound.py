"""Device time a step of the EM shell's finish: the operations launched
under the program's ``fusion_sim.finish`` span (the fillers' positions
and velocities zeroed by ``torch.where``), in the cells whose pace the
device sets."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "finish")
