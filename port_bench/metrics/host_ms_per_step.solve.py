"""Host ms a call in the grid phase at the untraced pace: the self time of
the program's ``solve``, ``fields`` and ``density`` spans, from the host
clock behind the program's spans
(``fusion_sim_torch.utils.profiling.host_times()``), summed over its
records, the last 512 ``step(1)`` calls (pusher: app frames) before the
traced segment, so the untraced window's, over their count; None on a
run with no device operation (a CPU run), and where the program keeps no
such clock or it closed no record."""

PHASES = ("solve", "fields", "density")


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    from fusion_sim_torch.utils import profiling

    host_times = getattr(profiling, "host_times", None)
    times = None if host_times is None else host_times()
    if not times or not times["calls"]:
        return None
    return sum(times["self_ns"][p] for p in PHASES) / times["calls"] / 1e6
