"""Per-phase wall-time profiling and trace hooks (port of
``fusion_sim_tpu/utils/profiling.py``).

* ``sync`` — a device fence: ``torch.cuda.synchronize`` of each card the
  tensors of a tree live on; nothing on the CPU.
* ``Timer`` — named wall-time accumulators with optional fences.
* ``trace`` — a ``torch.profiler`` scope that writes a Chrome trace into
  ``log_dir`` (the reference's ``jax.profiler`` scope); no-op for None.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from .debug import leaves_with_path


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
    where there is a card, CUDA activity); no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
