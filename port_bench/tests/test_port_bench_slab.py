"""The readers of the sharded slab's own spans and counter
(``halo_ms_per_step``, ``migrate_ms_per_step``, ``rows_migrated_per_step``
under the names ``BENCHMARK.json`` gives them): the device time under the
``fusion_sim.halo`` and ``fusion_sim.migrate`` spans against hand-counted
values of a small synthetic chrome trace, the counter of the last
recording (kept on the device, read once), the spans of a tiny traced run
of the slab cell, and silence on CPU runs and on a program that has no
such span or counter."""

import copy
import gzip
import json
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fusion_sim_torch.utils import profiling
from port_bench import harness, trace
from port_bench.tests.tiny import run_tiny

CELL = "es3d-slab512-125m.thermal-resort"
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def _named(base):
    return [m["name"] for m in BENCH["per_layer"]
            if m["name"].split(".")[0] == base]


HALO, MIGRATE, ROWS = (_named(b) for b in ("halo_ms_per_step",
                                            "migrate_ms_per_step",
                                            "rows_migrated_per_step"))
SPANS = {**{n: "halo" for n in HALO}, **{n: "migrate" for n in MIGRATE}}


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _read(name, ctx):
    return harness.load_file("metrics", name).read(ctx)


def _events(halo=True, migrate=True):
    """Window 0-1000 us, one step 100-900 (of a segment of 2 steps); halo
    spans 100-150 and 600-650, migrate 700-800, solve 300-400; kernels of
    40 us and 10 us under the halos, 30 under migrate, 20 under solve and
    50 outside every phase."""
    events = [_x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
              _x("fusion_sim.step", "user_annotation", 100.0, 800.0),
              _x("fusion_sim.solve", "user_annotation", 300.0, 100.0)]
    if halo:
        events += [_x("fusion_sim.halo", "user_annotation", 100.0, 50.0),
                   _x("fusion_sim.halo", "user_annotation", 600.0, 50.0)]
    if migrate:
        events.append(_x("fusion_sim.migrate", "user_annotation", 700.0,
                         100.0))
    for corr, (t, dur) in enumerate([(120.0, 40.0), (610.0, 10.0),
                                     (750.0, 30.0), (350.0, 20.0),
                                     (950.0, 50.0)], 1):
        events += [_x("cudaLaunchKernel", "cuda_runtime", t, 5.0, corr),
                   _x(f"kernel_{corr}", "kernel", t + 10.0, dur, corr)]
    return events


def test_the_readers_are_named():
    assert HALO and MIGRATE and ROWS
    for name in HALO + MIGRATE + ROWS:
        entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [CELL]


@pytest.mark.parametrize("halo,migrate", [(True, True), (False, True),
                                          (True, False)])
def test_span_readers_against_hand_counts(tmp_path, halo, migrate):
    path = tmp_path / "seg.json.gz"
    _write(path, _events(halo, migrate))
    ctx = SimpleNamespace(trace=trace.read_trace(path, 2))
    for name in HALO:
        want = 0.025 if halo else None     # (40 + 10) us over 2 steps
        assert _read(name, ctx) == (want if want is None
                                    else pytest.approx(want)), name
    for name in MIGRATE:
        want = 0.015 if migrate else None
        assert _read(name, ctx) == (want if want is None
                                    else pytest.approx(want)), name


@pytest.mark.parametrize("on_device", [False, True])
def test_counter_reader_reads_the_last_recording(tmp_path, on_device):
    """Counts of 12 and 30 rows in a recording of 2 steps (on the device:
    0-d tensors, read only by the reader), then an untraced step."""
    path = tmp_path / "seg.json.gz"
    _write(path, _events())
    ctx = SimpleNamespace(trace=trace.read_trace(path, 2))
    profiling.span("step")      # seen untraced: the recording counts anew
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (12, 30):
            profiling.count("rows_migrated",
                            (lambda n=n: torch.tensor(n)) if on_device
                            else n)
    profiling.span("step")
    for name in ROWS:
        assert _read(name, ctx) == pytest.approx(21.0), name


def test_silent_where_the_program_has_no_such_span_or_counter(tmp_path):
    """A parent program's trace (no halo or migrate span) and a recording
    that counted no migrant: every reader is None."""
    path = tmp_path / "seg.json.gz"
    _write(path, _events(halo=False, migrate=False))
    ctx = SimpleNamespace(trace=trace.read_trace(path, 2))
    profiling.span("step")
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("rows_patched", 3)
    for name in HALO + MIGRATE + ROWS:
        assert _read(name, ctx) is None, name


def _with_device_twins(path, out):
    """The CPU trace at ``path`` with a 1 us device twin for each CPU
    operator, launched at its start: the events and the launch times."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches = [float(e["ts"]) for e in events if e.get("cat") == "cpu_op"]
    for corr, t in enumerate(launches, 10 ** 9):
        events += [_x("cudaLaunchKernel", "cuda_runtime", t, 0.5, corr),
                   _x("twin", "kernel", t, 1.0, corr)]
    _write(out, events)
    return events, launches


def test_readers_read_a_tiny_traced_run(tmp_path, monkeypatch):
    """The slab cell traced on the CPU at its kind's small size (rows cross
    the x faces every step): the span readers read the twins launched
    under their spans, per step, the counter the rows that left the slab,
    and on the CPU run itself every reader is silent."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    loaded = harness.load_cell(CELL)
    result, _ = run_tiny(CELL, traced=True,
                         config=copy.deepcopy(loaded.config))
    assert result["correct"], result["checks"]
    assert result["metrics"] == {}
    counts = profiling.counters()
    steps = int(loaded.config["layouts"]["resort"]["trace_steps"])
    out = tmp_path / "twins.json.gz"
    events, launches = _with_device_twins(trace.trace_path(CELL), out)
    ctx = SimpleNamespace(trace=trace.read_trace(out, steps))
    for name, span in SPANS.items():
        ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "fusion_sim." + span]
        under = sum(any(a <= t <= b for a, b in ivs) for t in launches)
        assert under > 0, name
        assert _read(name, ctx) == pytest.approx(1e-3 * under / steps), name
    assert counts["rows_migrated"] > 0
    for name in ROWS:
        assert _read(name, ctx) == pytest.approx(
            counts["rows_migrated"] / steps), name
