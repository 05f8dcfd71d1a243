"""The readers of the program's own spans and counter
(``metrics/_program.py`` and the six metrics that use it): the trace
found by its window, the synchronising calls, their host time and the
device idle time after them, against hand-counted values of a small
synthetic chrome trace; and silence on CPU runs."""

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
           "rows_patched_per_step", "finish_ms_per_step.device_bound"]


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
