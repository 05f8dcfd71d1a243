"""Rows a step that the sinks absorbed and the source respawned,
min(count, capacity) a half-step: the program's ``rows_respawned``
counter over the traced segment's recording
(``fusion_sim_torch.utils.profiling.counters()``)."""


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    from fusion_sim_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    n = None if counters is None else counters().get("rows_respawned")
    return None if n is None else n / ctx.trace.steps
