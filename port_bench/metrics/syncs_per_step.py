"""Synchronising calls a step: the CUDA runtime's stream, device and
event synchronises that start inside the program's ``fusion_sim.step``
spans (the per-step host reads and the pageable uploads), over the
segment's steps."""

from . import _program


def read(ctx):
    seg = _program.segment(ctx)
    if seg is None:
        return None
    return len(seg.syncs) / ctx.trace.steps
