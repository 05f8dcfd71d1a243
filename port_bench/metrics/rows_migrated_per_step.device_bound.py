"""Rows a step that left the shard's slab over either x face: the
program's ``rows_migrated`` counter over the traced segment's recording
(``fusion_sim_torch.utils.profiling.counters()``), counted on the device
and read once after the segment, which the checked steps after it, run
with no profiler, leave as it was."""


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    from fusion_sim_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    n = None if counters is None else counters().get("rows_migrated")
    return None if n is None else n / ctx.trace.steps
