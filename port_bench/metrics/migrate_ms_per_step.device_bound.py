"""Device time a step of the slab decomposition's migration: the
operations launched under the program's ``fusion_sim.migrate`` span (the
wrap back to global units, the migration masks, the pack, the exchange
and the seating of the arrivals; on a ring of one, the wrap alone)."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "migrate")
