"""Host time a step spent inside the synchronising calls that
``syncs_per_step`` counts, in ms."""

from . import _program


def read(ctx):
    seg = _program.segment(ctx)
    if seg is None:
        return None
    return 1e-3 * sum(b - a for a, b in seg.syncs) / ctx.trace.steps
