"""Device time a step of the slab decomposition's halos: the operations
launched under the program's ``fusion_sim.halo`` spans (the apron fold
of the deposit onto the neighbours' edges, the phi halo of the gradient
and the E halo the kernel gathers from; on a ring of one, local copies
of the slab's own opposite face)."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "halo")
