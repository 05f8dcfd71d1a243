"""Device time a step of the exact spill patch: the operations launched
under the program's ``fusion_sim.patch`` span (the spill mask and count,
the compaction, the exact re-push and deposit, the write-back)."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "patch")
