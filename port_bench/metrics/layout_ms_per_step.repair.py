"""Device time of the layout's upkeep under repair, per step: the
operations launched under the ``repair`` span (``repair_relocate``) and
the ``resort`` span (the resorts that drained stacks call for)."""


def read(ctx):
    t = ctx.trace
    if not t.span_count.get("repair") or not t.device_ops:
        return None
    return 1e3 * (t.span_device_s["repair"]
                  + t.span_device_s.get("resort", 0.0)) / t.steps
