"""Per-phase wall-time profiling and trace hooks (port of
``fusion_sim_tpu/utils/profiling.py``).

* ``sync`` — a device fence: ``torch.cuda.synchronize`` of each card the
  tensors of a tree live on; nothing on the CPU.
* ``Timer`` — named wall-time accumulators with optional fences.
* ``trace`` — a ``torch.profiler`` scope that writes a Chrome trace into
  ``log_dir`` (the reference's ``jax.profiler`` scope); no-op for None.
* ``span`` / ``count`` / ``counters`` — the program's own phase spans and
  counters.  While a ``torch.profiler`` records, a span is a
  ``record_function("fusion_sim.<name>")`` user annotation, which shares
  the clock of the profiler's device trace, so device time and idle gaps
  can be charged to the phase that launched them; a count adds to a plain
  int, or to a count on the device that ``counters()`` reads, so that
  counting adds no host read to a step.  With no profiler recording,
  ``span`` returns the one shared host clock after a single
  ``_profiler_enabled()`` check and ``count`` does nothing.  The first
  ``span`` or ``count`` of a new recording (one that follows a call which
  saw no profiler) clears the counters, so ``counters()`` holds the last
  recording's counts.
* ``host_times`` — what the host clock kept: each span's self time (its
  duration less its child spans') and calls by phase, summed over the
  last ``RING`` public calls, each from the entry of one
  ``fusion_sim.step`` span to the next (the pusher's ``density()`` after
  its ``step`` falls in the step's record).  The clock keeps nothing
  while a profiler records, and ``host_times()`` holds the ring as it
  stood when the last recording began, so a traced run reads the host
  time of the untraced calls before it.  Spans of names outside
  ``PHASES`` (the sharded shells' ``halo`` and ``migrate``) count under
  ``other``.
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
_counts: dict[str, int] = {}
_now = time.perf_counter_ns
_stale = True   # a call saw no profiler since the counters were cleared

# the host clock's phases; a span of any other name counts under "other"
PHASES = ("step", "solve", "fields", "kernel", "patch", "repair", "finish",
          "resort", "respawn", "drain_check", "density", "host_read",
          "other")
_N = len(PHASES)
# a phase's place in the clock's totals: [clock ns, self ns by phase,
# calls by phase]; its calls sit _N places after its self ns
_AT = {name: 1 + i for i, name in enumerate(PHASES)}
_STEP, _OTHER = _AT["step"], _AT["other"]
_WIDTH = 1 + 2 * _N
RING = 512      # closed records the clock keeps


class _Clock:
    """The host clock behind ``span`` while no profiler records: one shared
    context whose ``phase`` ``span`` sets just before the ``with`` enters
    it, so each ``span(...)`` is entered at once, by one thread at a time
    (the viewer steps its model under a lock).

    It keeps the stack of the open spans' phases and, at each entry and
    exit, charges the time since the last one to the innermost open span:
    its self time (its duration less its child spans').  An exit also
    counts one call.  The entry of each outermost ``step`` span closes a
    record: a copy of the running totals, stamped with the clock, goes into
    a ring of ``RING + 1`` such copies, so the sum of the last k records
    is the newest copy less the one k before it, read in O(phases)."""

    __slots__ = ("phase", "_open", "_last", "_totals", "_skew", "_opened",
                 "_ring", "_head", "_closed", "frozen")

    def __init__(self):
        self.phase = _OTHER
        self._open: list[int] = []      # open spans' phases, outermost first
        self._last = 0          # ns of the last entry or exit
        self._totals = [0] * _WIDTH
        self._skew = 0          # ns left out of the clock (the gaps)
        self._opened = False    # whether a record is open
        self._ring: list = [None] * (RING + 1)
        self._head = 0          # the ring's next slot
        self._closed = 0        # records the ring spans, <= RING
        self.frozen = None      # (records, sums) when a recording began

    def __enter__(self):
        now = _now()
        if self._open:
            self._totals[self._open[-1]] += now - self._last
        elif self.phase == _STEP:
            self._close(now)
        self._open.append(self.phase)
        self._last = now
        return self

    def __exit__(self, *exc):
        now = _now()
        phase = self._open.pop()
        totals = self._totals
        totals[phase] += now - self._last
        totals[phase + _N] += 1
        self._last = now
        return False

    def _close(self, now: int) -> None:
        """Close the open record and open the next at ``now``.  With no
        record open, what the totals gained since the last copy (a record
        dropped by ``freeze``, the spans before the first step) is taken
        back, and the clock skips the gap."""
        totals = self._totals
        last = self._ring[self._head - 1]
        if self._opened or last is None:
            totals[0] = now - self._skew
            self._ring[self._head] = list(totals)
            self._head = (self._head + 1) % (RING + 1)
            self._closed = min(self._closed + self._opened, RING)
        else:
            self._skew = now - last[0]
            totals[:] = last
        self._opened = True

    def _sums(self) -> tuple[int, list[int]]:
        k = self._closed
        if not k:
            return 0, [0] * _WIDTH
        new = self._ring[self._head - 1]
        old = self._ring[(self._head - 1 - k) % (RING + 1)]
        return k, [a - b for a, b in zip(new, old)]

    def freeze(self) -> None:
        """Keep the closed records' sums for ``host_times`` and drop the
        open record, whose calls the profiler now takes."""
        self.frozen = self._sums()
        self._opened = False

    def times(self) -> dict:
        k, sums = self.frozen or self._sums()
        return {"calls": k, "wall_ns": sums[0],
                "self_ns": dict(zip(PHASES, sums[1:1 + _N])),
                "count": dict(zip(PHASES, sums[1 + _N:]))}


_CLOCK = _Clock()


def _clear() -> None:
    global _stale
    _counts.clear()
    _CLOCK.freeze()
    _stale = False


def _recording() -> bool:
    """Whether a profiler records; the first call that sees one after a
    call that saw none clears the counters and freezes the host clock's
    ring."""
    global _stale
    if not _profiler_enabled():
        _stale = True
        return False
    if _stale:
        _clear()
    return True


def span(name: str):
    """``record_function("fusion_sim." + name)`` while a profiler records,
    else the shared host clock, set to the phase ``name``."""
    if _recording():
        return torch.profiler.record_function(PREFIX + name)
    _CLOCK.phase = _AT.get(name, _OTHER)
    return _CLOCK


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records.  ``n`` is
    an int, or a function of no arguments that gives one or a count on
    the device (a 0-d integer tensor): it is called only while a profiler
    records, and a device count is summed on the device and read by
    ``counters()``, so that counting adds no host read to a step."""
    if _recording():
        if callable(n):
            n = n()
        _counts[name] = _counts.get(name, 0) + (n if torch.is_tensor(n)
                                                else int(n))


def counters() -> dict[str, int]:
    """The counts of the current (or last) recording (a count kept on the
    device is read here)."""
    return {k: int(v) for k, v in _counts.items()}


def host_times() -> dict:
    """The host clock's closed records as they stood when the last profiler
    recording began (with none yet, as they stand):
    ``{"calls": k, "wall_ns": ..., "self_ns": {phase: ...},
    "count": {phase: ...}}``, each summed over the k records (k <=
    ``RING``); a record's wall time also holds what ran outside every
    span between its ``step`` and the next."""
    return _CLOCK.times()


def _reset_clock() -> None:
    """A new host clock, as at import (for tests)."""
    global _CLOCK
    _CLOCK = _Clock()


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
