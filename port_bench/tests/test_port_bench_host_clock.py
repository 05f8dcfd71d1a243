"""The five readers of the program's host clock
(``fusion_sim_torch.utils.profiling.host_times()``): their cells in
``BENCHMARK.json``, their values against planted times, silence on an
empty ring, on a program without the clock and on a CPU run, and a tiny
traced run of the ES cell, whose clock holds the calls before the traced
segment and none after it."""

import copy
import json
from types import SimpleNamespace

import pytest

from fusion_sim_torch.utils import profiling
from port_bench import harness, trace
from port_bench.tests.tiny import run_tiny, tiny_config

# metric -> the phases whose self time it sums
READERS = {"host_ms_per_step.shell": ("step",),
           "host_ms_per_step.layout": ("patch", "resort", "repair", "finish",
                                       "respawn", "drain_check"),
           "host_ms_per_step.solve": ("solve", "fields", "density"),
           "host_ms_per_step.kernel": ("kernel",),
           "read_wait_ms_per_step": ("host_read",)}
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
ON_CARD = SimpleNamespace(trace=SimpleNamespace(device_ops=1))


def _read(name, ctx):
    return harness.load_file("metrics", name).read(ctx)


def _planted(calls, phase_ns):
    return {"calls": calls, "wall_ns": 10 ** 9,
            "self_ns": {p: phase_ns.get(p, 0) for p in profiling.PHASES},
            "count": {p: calls for p in profiling.PHASES}}


def test_clock_readers_cover_the_host_paced_cells():
    host_paced = next(m for m in BENCH["end_to_end"]
                      if m["name"] == "particle_updates_per_s")["workloads"]
    listed = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in READERS}
    assert set(listed) == set(READERS)
    for m in listed.values():
        assert m["workloads"] == host_paced
        assert (m["source"], m["moves"], m["unit"]) == (
            "program_span", "particle_updates_per_s", "ms/step")


def test_clock_readers_against_planted_times(monkeypatch):
    """Each reader: its phases' self ns summed, over the calls, in ms;
    every phase but "other" is read, by one reader."""
    ns = {p: 1000 * (i + 1) for i, p in enumerate(profiling.PHASES)}
    monkeypatch.setattr(profiling, "host_times", lambda: _planted(4, ns))
    for name, phases in READERS.items():
        want = sum(ns[p] for p in phases) / 4 / 1e6
        assert _read(name, ON_CARD) == pytest.approx(want), name
    read = [p for phases in READERS.values() for p in phases]
    assert sorted(read) == sorted(set(profiling.PHASES) - {"other"})


def test_clock_readers_silent(monkeypatch):
    """On an empty ring, on a CPU run and on a program without the clock
    (the parent commit's)."""
    monkeypatch.setattr(profiling, "host_times", lambda: _planted(0, {}))
    for name in READERS:
        assert _read(name, ON_CARD) is None, name
    monkeypatch.setattr(profiling, "host_times",
                        lambda: _planted(3, {"kernel": 5}))
    cpu = SimpleNamespace(trace=SimpleNamespace(device_ops=0))
    for name in READERS:
        assert _read(name, cpu) is None, name
    monkeypatch.delattr(profiling, "host_times")
    for name in READERS:
        assert _read(name, ON_CARD) is None, name


def test_clock_readers_read_a_tiny_traced_run(tmp_path, monkeypatch):
    """A traced run of the ES cell on the CPU (one-cell sort margin, so
    that rows spill): the clock holds the calls before the traced segment,
    at most 512, and none after it; given a segment with device
    operations, the five readers report it, and the patch counter still
    reads the traced segment's count."""
    cell = "es2d-512sq-10m.thermal-resort"
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    loaded = harness.load_cell(cell)
    config = copy.deepcopy(loaded.config)
    config["tiling"]["margin"] = 1
    layout = tiny_config(cell, config)["layouts"][loaded.traffic["layout"]]
    segment = {}
    run_traced = trace.run_traced

    def traced(step, steps, device, name):
        segment["times"] = profiling.host_times()
        summary = run_traced(step, steps, device, name)
        segment["counts"] = profiling.counters()
        return summary

    monkeypatch.setattr(trace, "run_traced", traced)
    profiling._reset_clock()
    result, _ = run_tiny(cell, traced=True, config=config)
    assert not set(READERS) & set(result["metrics"])    # a CPU run
    times = profiling.host_times()
    assert times == segment["times"]
    calls = int(layout["warmup_steps"]) + result["attempted"] - 1
    assert times["calls"] == min(512, calls) > 0
    assert times["count"]["step"] == times["calls"]
    assert sum(times["self_ns"].values()) <= times["wall_ns"]
    for name, phases in READERS.items():
        want = sum(times["self_ns"][p] for p in phases) / times["calls"] / 1e6
        assert want > 0, name
        assert _read(name, ON_CARD) == pytest.approx(want), name
    steps = int(layout["trace_steps"])
    ctx = SimpleNamespace(trace=SimpleNamespace(device_ops=1, steps=steps))
    assert segment["counts"]["rows_patched"] > 0
    assert _read("rows_patched_per_step", ctx) == pytest.approx(
        segment["counts"]["rows_patched"] / steps)
