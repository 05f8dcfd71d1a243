"""Host ms a call in the layout at the untraced pace: the self time of the
program's ``patch``, ``resort``, ``repair``, ``finish``, ``respawn`` and
``drain_check`` spans. The implicit ``.item()`` syncs of
``ops/repair._put`` (0-d tensor indices) wait here, not under
``host_read``, which holds only the deliberate reads. From the host
clock behind the program's spans
(``fusion_sim_torch.utils.profiling.host_times()``), summed over its
records, the last 512 ``step(1)`` calls (pusher: app frames) before the
traced segment, so the untraced window's, over their count; None on a
run with no device operation (a CPU run), and where the program keeps no
such clock or it closed no record."""

PHASES = ("patch", "resort", "repair", "finish", "respawn", "drain_check")


def read(ctx):
    if not ctx.trace.device_ops:
        return None
    from fusion_sim_torch.utils import profiling

    host_times = getattr(profiling, "host_times", None)
    times = None if host_times is None else host_times()
    if not times or not times["calls"]:
        return None
    return sum(times["self_ns"][p] for p in PHASES) / times["calls"] / 1e6
