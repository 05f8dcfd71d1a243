"""Device time of the field solve per step: the operations launched under
the ``solve`` span (``poisson_fft`` in the ES shell, ``yee_update`` in the
EM shell)."""


def read(ctx):
    t = ctx.trace
    if not t.span_count.get("solve") or not t.device_ops:
        return None
    return 1e3 * t.span_device_s["solve"] / t.steps
