"""The readers of the program's own spans and counter
(``metrics/_program.py`` and the eleven metrics that use it): the trace
found by its window, the synchronising calls, their host time and the
device idle time after them, and the device time under the layout and
solve spans, against hand-counted values of small synthetic chrome
traces; the layout and solve readers on the spans of tiny traced runs of
their cells; and silence on CPU runs."""

import copy
import gzip
import json
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from fusion_sim_torch.utils import profiling
from port_bench import harness, trace
from port_bench.tests.tiny import run_tiny

READERS = ["syncs_per_step", "sync_ms_per_step",
           "sync_stall_ms_per_step.device_bound", "patch_ms_per_step",
           "rows_patched_per_step", "finish_ms_per_step.device_bound",
           "layout_ms_per_step.resort", "layout_ms_per_step.repair",
           "layout_ms_per_step.resort.host_bound",
           "solve_ms_per_step", "solve_ms_per_step.device_bound"]
# the readers of device time under program spans: metric -> its spans
SPAN_READERS = {"layout_ms_per_step.resort": ("resort",),
                "layout_ms_per_step.resort.host_bound": ("resort",),
                "layout_ms_per_step.repair": ("repair", "resort"),
                "solve_ms_per_step": ("solve",),
                "solve_ms_per_step.device_bound": ("solve",)}
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPAN_CELLS = sorted({c for m in BENCH["per_layer"] if m["name"] in
                     SPAN_READERS for c in m["workloads"]})


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _segment_events():
    """Window 1000-2000 us; steps 1100-1400 and 1500-1900.  Device busy
    1010-1240, 1300-1610 (a kernel and an overlapping copy), 1700-1990.
    Synchronises in steps end at 1250 (gap 1240-1300), 1620 and 1630
    (both in gap 1610-1700); one at 1950-1980 ends outside every step,
    as the harness's own does, and one at 1050 starts before the first."""
    return [
        _x(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        _x("fusion_sim.step", "user_annotation", 1100.0, 300.0),
        _x("fusion_sim.step", "user_annotation", 1500.0, 400.0),
        _x("fusion_sim.patch", "user_annotation", 1150.0, 100.0),
        _x("fusion_sim.finish", "user_annotation", 1640.0, 20.0),
        _x("cudaLaunchKernel", "cuda_runtime", 1005.0, 4.0, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1160.0, 5.0, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 1650.0, 5.0, corr=3),
        _x("cudaStreamSynchronize", "cuda_runtime", 1050.0, 20.0),
        _x("cudaStreamSynchronize", "cuda_runtime", 1200.0, 50.0),
        _x("cudaDeviceSynchronize", "cuda_runtime", 1600.0, 20.0),
        _x("cudaEventSynchronize", "cuda_runtime", 1620.0, 10.0),
        _x("cudaMemcpyAsync", "cuda_runtime", 1560.0, 10.0),
        _x("cudaStreamSynchronize", "cuda_runtime", 1950.0, 30.0),
        _x("kernel_a", "kernel", 1010.0, 230.0, corr=1),
        _x("kernel_b", "kernel", 1300.0, 300.0, corr=2),
        _x("Memcpy DtoH", "gpu_memcpy", 1580.0, 30.0),
        _x("kernel_c", "kernel", 1700.0, 290.0, corr=3),
    ]


def _write(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.fixture
def synthetic(tmp_path, monkeypatch):
    """The segment's trace beside a longer segment's and a file with no
    window, under ``$TMPDIR/port_bench``; the context a reader gets."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    d = tmp_path / "port_bench"
    _write(d / "a-cell.json.gz", _segment_events())
    longer = _segment_events()
    longer[0] = _x(trace.WINDOW, "user_annotation", 1000.0, 2000.0)
    longer = [e for e in longer if e["name"] != "cudaDeviceSynchronize"]
    _write(d / "b-cell.json.gz", longer)
    _write(d / "c-cell.json.gz", [_x("aten::add", "cpu_op", 0.0, 1.0)])
    summary = trace.read_trace(d / "a-cell.json.gz", 2)
    return SimpleNamespace(trace=summary)


def _read(name, ctx):
    return harness.load_file("metrics", name).read(ctx)


def test_finds_the_segment_by_its_window(synthetic):
    from port_bench.metrics import _program

    seg = _program.segment(synthetic)
    assert seg.window == (1000.0, 2000.0)
    assert seg.steps == [(1100.0, 1400.0), (1500.0, 1900.0)]
    # the file whose window is twice as long is not this segment
    synthetic.trace.window_s *= 2
    assert _program.segment(synthetic).window == (1000.0, 3000.0)
    synthetic.trace.window_s *= 1.5
    assert _program.segment(synthetic) is None


def test_sync_readers_against_hand_counts(synthetic):
    # three calls start inside the steps: 50 + 20 + 10 us of host time
    assert _read("syncs_per_step", synthetic) == pytest.approx(1.5)
    assert _read("sync_ms_per_step", synthetic) == pytest.approx(0.040)
    # gaps 1240-1300 (60 us) and 1610-1700 (90 us, two ends, counted
    # once); 1000-1010 and 1990-2000 hold no end of a counted call
    assert _read("sync_stall_ms_per_step.device_bound", synthetic) \
        == pytest.approx(0.075)


def test_span_readers_against_hand_counts(synthetic):
    # kernel_b (300 us) was launched under fusion_sim.patch, kernel_c
    # (290 us) under fusion_sim.finish
    assert _read("patch_ms_per_step", synthetic) == pytest.approx(0.150)
    assert _read("finish_ms_per_step.device_bound", synthetic) \
        == pytest.approx(0.145)


def _layout_events(resort=True, repair=True):
    """Window 0-1000 us, one step 100-900 (of a segment of 2 steps);
    resort 100-200, repair 300-400, solve 500-600; kernels of 40 us
    (resort), 30 (repair), 20 (solve) and 50 (outside every phase)."""
    events = [_x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
              _x("fusion_sim.step", "user_annotation", 100.0, 800.0),
              _x("fusion_sim.solve", "user_annotation", 500.0, 100.0)]
    if resort:
        events.append(_x("fusion_sim.resort", "user_annotation", 100.0,
                         100.0))
    if repair:
        events.append(_x("fusion_sim.repair", "user_annotation", 300.0,
                         100.0))
    for corr, (t, dur) in enumerate([(150.0, 40.0), (350.0, 30.0),
                                     (550.0, 20.0), (700.0, 50.0)], 1):
        events += [_x("cudaLaunchKernel", "cuda_runtime", t, 5.0, corr),
                   _x(f"kernel_{corr}", "kernel", t + 10.0, dur, corr)]
    return events


@pytest.mark.parametrize("resort,repair,expect", [
    (True, True, {"layout_ms_per_step.resort": 0.020,
                  "layout_ms_per_step.resort.host_bound": 0.020,
                  "layout_ms_per_step.repair": 0.035,
                  "solve_ms_per_step": 0.010,
                  "solve_ms_per_step.device_bound": 0.010}),
    # a repair segment that holds no resort; a resort cell
    (False, True, {"layout_ms_per_step.resort": None,
                   "layout_ms_per_step.repair": 0.015}),
    (True, False, {"layout_ms_per_step.resort": 0.020,
                   "layout_ms_per_step.resort.host_bound": 0.020,
                   "layout_ms_per_step.repair": None}),
])
def test_layout_and_solve_readers_against_hand_counts(tmp_path, resort,
                                                      repair, expect):
    path = tmp_path / "seg.json.gz"
    _write(path, _layout_events(resort, repair))
    ctx = SimpleNamespace(trace=trace.read_trace(path, 2))
    for name, value in expect.items():
        assert _read(name, ctx) == (value if value is None
                                    else pytest.approx(value)), name


def _with_device_twins(path, out):
    """The CPU trace at ``path`` with a device twin for each CPU operator
    (a launch at the operator's start and a 1 us kernel sharing its
    correlation id), written to ``out``: its complete events and the
    twins' launch times."""
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    launches = [float(e["ts"]) for e in events if e.get("cat") == "cpu_op"]
    for corr, t in enumerate(launches, 10 ** 9):
        events += [_x("cudaLaunchKernel", "cuda_runtime", t, 0.5, corr),
                   _x("twin", "kernel", t, 1.0, corr)]
    _write(out, events)
    return events, launches


@pytest.mark.parametrize("cell", SPAN_CELLS)
def test_span_readers_read_a_tiny_traced_run(cell, tmp_path, monkeypatch):
    """The program's own resort, repair and solve spans in a traced run of
    the cell on the CPU (with a one-cell sort margin, so that rows spill
    and relocation has work), each CPU operator given a 1 us device twin:
    every layout and solve metric of the cell reads the twins launched
    under its spans, per step."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    loaded = harness.load_cell(cell)
    config = copy.deepcopy(loaded.config)
    config["tiling"]["margin"] = 1
    run_tiny(cell, traced=True, config=config)
    steps = int(loaded.config["layouts"][loaded.traffic["layout"]]
                ["trace_steps"])
    out = tmp_path / "twins.json.gz"
    events, launches = _with_device_twins(trace.trace_path(cell), out)
    summary = trace.read_trace(out, steps)
    ctx = SimpleNamespace(trace=summary)
    names = [m["name"] for m in loaded.per_layer if m["name"] in SPAN_READERS]
    assert names
    for name in names:
        spans = ["fusion_sim." + s for s in SPAN_READERS[name]]
        assert summary.span_count.get(spans[0]), (name, spans[0])
        ivs = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "user_annotation"
               and e.get("name") in spans]
        under = sum(any(a <= t <= b for a, b in ivs) for t in launches)
        assert under > 0, name
        assert _read(name, ctx) == pytest.approx(1e-3 * under / steps), name


def test_counter_reader_reads_the_last_recording(synthetic):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("rows_patched", 12)
    profiling.span("step")              # a step after it, untraced
    assert _read("rows_patched_per_step", synthetic) == pytest.approx(6.0)


def test_readers_silent_without_step_spans(synthetic, tmp_path):
    events = [e for e in _segment_events()
              if not e["name"].startswith("fusion_sim.")]
    _write(tmp_path / "port_bench" / "a-cell.json.gz", events)
    for name in READERS[:3]:
        assert _read(name, synthetic) is None, name
    ctx = SimpleNamespace(trace=trace.read_trace(
        tmp_path / "port_bench" / "a-cell.json.gz", 2))
    for name in ("patch_ms_per_step", "finish_ms_per_step.device_bound"):
        assert _read(name, ctx) is None, name


@pytest.mark.parametrize("cell", ["es2d-512sq-10m.thermal-resort",
                                  "em3d-128cube-30m.thermal-resort"])
def test_readers_silent_on_a_cpu_run(cell):
    result, _ = run_tiny(cell, traced=True)
    assert result["metrics"] == {}
    steps = int(harness.load_cell(cell).config["layouts"][
        harness.load_cell(cell).traffic["layout"]]["trace_steps"])
    summary = trace.read_trace(trace.trace_path(cell), steps)
    assert summary.device_ops == 0
    assert summary.span_count.get("fusion_sim.step") == steps
    ctx = SimpleNamespace(trace=summary)
    for name in READERS:
        assert _read(name, ctx) is None, name
