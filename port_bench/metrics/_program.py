"""Shared by the readers of the program's own spans and counters
(``fusion_sim_torch/utils/profiling.py``): the shells open
``fusion_sim.<phase>`` spans and count ``rows_patched`` while a profiler
records, so the traced segment holds them on the device trace's clock.

A reader gets the segment's ``Summary`` but not its cell, so the trace is
found among ``$TMPDIR/port_bench/*.json.gz`` by the duration of its
``port_bench.window`` span, which is the summary's ``window_s``.  A
synchronising call is a ``cuda_runtime`` event named
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or
``cudaEventSynchronize`` that starts inside a ``fusion_sim.step`` span;
the harness's own synchronise at the end of the segment lies outside
every step.  Each reader returns None where the trace holds no device
operation, no such file is found, or the program opens no
``fusion_sim.step`` span.
"""

from __future__ import annotations

import gzip
import json
import os
import tempfile
from dataclasses import dataclass
from pathlib import Path

from .. import trace

STEP = "fusion_sim.step"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
MATCH_S = 1e-9      # window durations that differ by less are one segment

_parsed: dict = {}


@dataclass
class Segment:
    """One traced segment (times in the trace's microseconds)."""

    window: tuple[float, float]
    steps: list[tuple[float, float]]
    syncs: list[tuple[float, float]]    # starting inside a step span
    busy: list[tuple[float, float]]     # union of device intervals


def trace_dir() -> Path:
    """Where ``port_bench/trace.py`` writes the segments' traces."""
    return Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) \
        / "port_bench"


def _within(ivs: list[tuple[float, float]], t: float) -> bool:
    return any(a <= t <= b for a, b in ivs)


def parse(path: Path) -> Segment | None:
    """The segment of one trace file (None without a window span)."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == trace.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("name") == STEP
                   and e.get("cat") == "user_annotation")
    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name") in SYNCS
                   and _within(steps, float(e["ts"])))
    dev = []
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
    return Segment((w0, w1), steps, syncs, trace._union(dev))


def _cached(path: Path) -> Segment | None:
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _parsed:
        _parsed[key] = parse(path)
    return _parsed[key]


def segment(ctx) -> Segment | None:
    """The traced segment of this run, with the program's step spans."""
    t = ctx.trace
    if not t.device_ops or t.window_s <= 0:
        return None
    best = None
    for path in sorted(trace_dir().glob("*.json.gz")):
        seg = _cached(path)
        if seg is None:
            continue
        off = abs((seg.window[1] - seg.window[0]) * 1e-6 - t.window_s)
        if off <= MATCH_S and (best is None or off < best[0]):
            best = (off, seg)
    if best is None or not best[1].steps:
        return None
    return best[1]


def idle_gaps(seg: Segment) -> list[tuple[float, float]]:
    """The window's intervals in which no device operation ran."""
    edges = ([seg.window[0]] + [x for iv in seg.busy for x in iv]
             + [seg.window[1]])
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def stall_us(seg: Segment) -> float:
    """Device idle time in the gaps that hold the end of a synchronising
    call, each gap once."""
    ends = [b for _, b in seg.syncs]
    return sum(b - a for a, b in idle_gaps(seg)
               if any(a <= t <= b for t in ends))


def span_ms_per_step(ctx, name: str) -> float | None:
    """Device time launched under the program span ``fusion_sim.<name>``
    per step of the segment; None where the segment holds no device
    operation or no such span."""
    t = ctx.trace
    key = "fusion_sim." + name
    if not t.device_ops or not t.span_count.get(key):
        return None
    return 1e3 * t.span_device_s[key] / t.steps
