"""The pusher kind's own pieces: its load against the app's draw, the
rooflines of B2 and of ``density()`` against hand-worked counts, the
readers of the pusher's ``density`` span and ``rows_respawned`` counter
against a synthetic trace (and silent without them, as on a program that
has neither), and the fault that only ``speed`` catches."""

import gzip
import json
import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fusion_sim_torch.utils import profiling
from port_bench import harness, peaks, trace
from port_bench.tests import kinds
from port_bench.tests.tiny import run_tiny

CELL = "pusher-mirror-160k.app-frame"


def test_load_is_the_apps_cube_in_the_grid_frame():
    cell = harness.load_cell(CELL)
    config = dict(cell.config, n_particles=4096)
    K = harness.kind(config)
    x, v = K.inputs(config, cell.traffic, 2 ** 33 + 1, "cpu")
    x2, v2 = K.inputs(config, cell.traffic, 2 ** 33 + 1, "cpu")
    assert torch.equal(x, x2) and torch.equal(v, v2)
    nr, nz = config["physics"]["grid_shape"]
    r = x[:, 0] * config["physics"]["radius"] / nr
    z = x[:, 1] * config["physics"]["height"] / nz
    # a 0.2 m cube about the axis at z = 1 m: r up to 0.1 sqrt(2)
    assert r.min() >= 0 and r.max() <= 0.1 * math.sqrt(2)
    assert (z - 1.0).abs().max() <= 0.1
    # |v| per Cartesian component up to 0.001 c: |(v_r, v_theta)| up to
    # 0.001 sqrt(2), |v_z| up to 0.001
    assert torch.linalg.vector_norm(v[:, :2], dim=1).max() <= 1.5e-3
    assert v[:, 2].abs().max() <= 1e-3


def test_b2_counts_real_particles_and_the_table():
    b2 = harness.load_file("rooflines", "b2")
    # x, v, alive read (28 B), x, v, sink, in_win written (29 B); the
    # 13-channel table read once a cell
    assert b2.work(10, (4, 4)) == (10 * 57 + 16 * 52, 10 * 60)
    n_bytes, flops = b2.work(160_000, (400, 800))
    assert n_bytes == 160_000 * 57 + 320_000 * 52
    assert peaks.least_seconds(n_bytes, flops) == pytest.approx(
        25_760_000 / 3.35e12)


def test_density_counts_rows_grids_and_the_splat():
    dens = harness.load_file("rooflines", "pusher_density")
    # rows 24 B; grids 16 + 32 + 12 + 12 B a cell; the splat of the fewer
    # of rows and cells, 968 operations each, and 40 a cell
    assert dens.work(10, (4, 4)) == (10 * 24 + 16 * 72, 10 * 968 + 16 * 40)
    assert dens.work(100, (4, 4))[1] == 16 * 968 + 16 * 40


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _read(name, ctx):
    return harness.load_file("metrics", name).read(ctx)


def test_density_reader_against_hand_counts(tmp_path):
    """Window 0-1000 us, two frames; kernels of 40 us (in a step), 30 and
    20 us (under ``fusion_sim.density``)."""
    events = [_x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
              _x("fusion_sim.step", "user_annotation", 0.0, 300.0),
              _x("fusion_sim.density", "user_annotation", 300.0, 100.0),
              _x("fusion_sim.density", "user_annotation", 800.0, 100.0)]
    for corr, (t, dur) in enumerate([(100.0, 40.0), (350.0, 30.0),
                                     (850.0, 20.0)], 1):
        events += [_x("cudaLaunchKernel", "cuda_runtime", t, 5.0, corr),
                   _x(f"k{corr}", "kernel", t + 10.0, dur, corr)]
    path = tmp_path / "seg.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    ctx = SimpleNamespace(trace=trace.read_trace(path, 2))
    assert _read("density_ms_per_step", ctx) == pytest.approx(0.025)
    # a program without the span: silent
    events = [e for e in events if e["name"] != "fusion_sim.density"]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    ctx = SimpleNamespace(trace=trace.read_trace(path, 2))
    assert _read("density_ms_per_step", ctx) is None


def test_respawn_reader_reads_the_last_recording():
    ctx = SimpleNamespace(trace=SimpleNamespace(device_ops=5, steps=4))
    profiling.span("step")              # seen untraced: a new recording
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("rows_respawned", 10)
        profiling.count("rows_respawned", 6)
    assert _read("rows_respawned_per_step", ctx) == pytest.approx(4.0)
    profiling.span("step")
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("rows_patched", 1)
    # a recording without the counter, as on a program that has none
    assert _read("rows_respawned_per_step", ctx) is None
    # a segment that ran nothing on a device
    ctx.trace.device_ops = 0
    assert _read("rows_respawned_per_step", ctx) is None


def test_scaled_velocities_fail_speed_alone(monkeypatch):
    """Velocities 1 + 1e-5 a frame: every other number holds."""
    kinds.of("pusher").FAULTS["scaled"](monkeypatch)
    result, _ = run_tiny(CELL)
    checks = result["checks"]
    failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert failed == ["speed"], checks
    assert result["correct"] is False


def test_respawns_and_spill_in_the_tiny_run():
    """The tiny configuration reaches the walls and the margin: a traced
    tiny run counts respawns and patched rows, and a resort."""
    run_tiny(CELL, traced=True)
    counts = profiling.counters()
    assert counts.get("rows_respawned", 0) > 0
    assert counts.get("rows_patched", 0) > 0
    steps = harness.load_cell(CELL).config["layouts"]["resort"][
        "trace_steps"]
    summary = trace.read_trace(trace.trace_path(CELL), steps)
    assert summary.span_count.get("fusion_sim.resort")
    assert summary.span_count.get("fusion_sim.density") == steps
