"""Per-phase wall-time profiling and trace hooks (port of
``fusion_sim_tpu/utils/profiling.py``).

* ``sync`` — a device fence: ``torch.cuda.synchronize`` of each card the
  tensors of a tree live on; nothing on the CPU.
* ``Timer`` — named wall-time accumulators with optional fences.
* ``trace`` — a ``torch.profiler`` scope that writes a Chrome trace into
  ``log_dir`` (the reference's ``jax.profiler`` scope); no-op for None.
* ``span`` / ``count`` / ``counters`` — the program's own phase spans and
  counters, live only while a ``torch.profiler`` records: a span is then a
  ``record_function("fusion_sim.<name>")`` user annotation, which shares
  the clock of the profiler's device trace, so device time and idle gaps
  can be charged to the phase that launched them; a count adds to a plain
  int.  With no profiler recording, ``span`` returns one shared no-op
  context after a single ``_profiler_enabled()`` check and ``count`` does
  nothing.  The first ``span`` or ``count`` of a new recording (one that
  follows a call which saw no profiler) clears the counters, so
  ``counters()`` holds the last recording's counts.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch
from torch._C._autograd import _profiler_enabled

from .debug import leaves_with_path

PREFIX = "fusion_sim."
_NULL = contextlib.nullcontext()
_counts: dict[str, int] = {}
_stale = True   # a call saw no profiler since the counters were cleared


def _clear() -> None:
    global _stale
    _counts.clear()
    _stale = False


def _recording() -> bool:
    """Whether a profiler records; the first call that sees one after a
    call that saw none clears the counters."""
    global _stale
    if not _profiler_enabled():
        _stale = True
        return False
    if _stale:
        _clear()
    return True


def span(name: str):
    """``record_function("fusion_sim." + name)`` while a profiler records,
    else the shared no-op context."""
    if not _recording():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _counts[name] = _counts.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """The counts of the current (or last) recording."""
    return dict(_counts)


def sync(tree) -> None:
    """Wait for the devices the tree's tensors live on (CPU: nothing)."""
    devices = {leaf.device for _, leaf in leaves_with_path(tree)
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating named phase timers.

    Usage::

        t = Timer()
        with t.phase("push", fence=lambda: state):
            state = step(fields, state)
        print(t.report())

    ``fence`` is evaluated at context exit, so pass a zero-arg callable
    returning the phase's outputs."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                sync(fence() if callable(fence) else fence)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": total,
                "count": self.counts[name],
                "mean_ms": 1e3 * total / max(self.counts[name], 1),
            }
            for name, total in sorted(self.totals.items())
        }


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` scope writing ``log_dir/trace.json`` (the CPU and,
    where there is a card, CUDA activity) and the scope's ``counters()`` to
    ``log_dir/counters.json``; no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _clear()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)
