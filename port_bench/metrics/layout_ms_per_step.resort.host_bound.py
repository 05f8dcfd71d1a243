"""``layout_ms_per_step.resort`` in the cell whose step the host paces,
which moves ``step_ms_p95.host_bound``."""

from . import _program


def read(ctx):
    return _program.span_ms_per_step(ctx, "resort")
