"""Device time of the layout's upkeep under repair, per step: the
operations launched under the program's ``fusion_sim.repair`` span
(``repair_relocate``) and its ``fusion_sim.resort`` span (the resorts
that drained stacks call for, where the segment holds one)."""

from . import _program


def read(ctx):
    repair = _program.span_ms_per_step(ctx, "repair")
    if repair is None:
        return None
    return repair + (_program.span_ms_per_step(ctx, "resort") or 0.0)
