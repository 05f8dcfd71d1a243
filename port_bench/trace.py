"""The traced segment of a ``--trace 1`` run and what the per-layer
metrics read from it.

Spans are the program's own: while a profiler records, the shells open
``fusion_sim.<phase>`` spans (``fusion_sim_torch/utils/profiling.span``);
the benchmark patches and wraps nothing of the program.  A span's device
time is the time of the device operations launched inside it: a kernel
belongs to every span that held the host thread when its launch was
issued (the launch and the kernel share the profiler's correlation id).

The trace is written gzipped to ``$TMPDIR/port_bench/<cell>.json.gz``
(overwritten each run) and read back from there.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

WINDOW = "port_bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # of a kernel's name in the breakdown
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Summary:
    """What the traced segment showed (times in seconds)."""

    steps: int
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: int = 0
    kernels: dict[str, list[float]] = field(default_factory=dict)
    span_device_s: dict[str, float] = field(default_factory=dict)
    span_count: dict[str, int] = field(default_factory=dict)
    op_totals: dict[str, float] = field(default_factory=dict)
    idle_by_host: dict[str, float] = field(default_factory=dict)

    def kernel_times(self, pattern: str) -> list[float]:
        """Durations of every launch of the kernels whose name holds
        ``pattern``."""
        return [t for name, ts in self.kernels.items() if pattern in name
                for t in ts]


def trace_path(cell: str) -> Path:
    d = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "port_bench"
    d.mkdir(parents=True, exist_ok=True)
    return d / f"{cell}.json.gz"


def run_traced(step, steps: int, device: torch.device, cell: str) -> Summary:
    """``step()`` ``steps`` times under the profiler; the segment ends
    with a device synchronise inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    path = trace_path(cell)
    prof.export_chrome_trace(str(path))
    summary = read_trace(path, steps)
    if summary.window_s <= 0:
        summary.window_s = wall
    return summary


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_at(starts, events, t: float) -> str:
    """The innermost host event running at time ``t`` (or ``python``)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for ev in events[max(0, i - 256):i][::-1]:
        if ev[0] <= t <= ev[1] and (best is None
                                    or ev[1] - ev[0] < best[1] - best[0]):
            best = ev
    return best[2] if best is not None else "python"


def read_trace(path: Path, steps: int) -> Summary:
    """Reduce a chrome trace of the segment to a ``Summary``."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    s = Summary(steps=steps)
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return s
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    s.window_s = (w1 - w0) * 1e-6
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    span_iv = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") != WINDOW:
            span_iv.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    s.span_count = {k: len(v) for k, v in span_iv.items()}
    s.span_device_s = {k: 0.0 for k in span_iv}
    dev_iv = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dur = float(e["dur"]) * 1e-6
        dev_iv.append((a, b))
        s.device_ops += 1
        name = e.get("name", "?")
        s.op_totals[name] = s.op_totals.get(name, 0.0) + dur
        if e.get("cat") == "kernel":
            s.kernels.setdefault(name, []).append(dur)
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is not None:
            for span, ivs in span_iv.items():
                if any(lo <= t <= hi for lo, hi in ivs):
                    s.span_device_s[span] += dur
    busy = _union(dev_iv)
    s.busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "?")) for e in events
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            who = _host_at(starts, host, 0.5 * (a + b))
            s.idle_by_host[who] = s.idle_by_host.get(who, 0.0) + (b - a) * 1e-6
    return s


def breakdown(s: Summary) -> dict:
    """The ten device operations that took most time, and the idle time
    by what the host was doing, in seconds."""
    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(s.op_totals), "idle_gaps": top(s.idle_by_host)}
