"""BENCHMARK.json and the files it names: the contract's shapes, names
and characters, and every configuration, traffic mix, metric reader and
roofline found by name."""

import json
import re

import pytest

from port_bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"shell", "layout", "solve", "kernel", "device"}
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = {w["name"] for w in BENCH["workloads"]}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith("port_bench/configs/")
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    assert all(NAME.match(k) for k in entry["reduced"])
    assert set(config["limits"]) >= {"count", "dropped", "nonfinite",
                                     "start", "moments"}
    for layout in config["layouts"].values():
        assert layout["warmup_steps"] > 0 and layout["trace_steps"] > 0


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and _line(cell["why"])
    loaded = harness.load_cell(cell["name"])
    assert loaded.traffic["layout"] in loaded.config["layouts"]
    reported = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    for m in loaded.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])
    assert loaded.per_layer, "every cell reports a per-layer metric"
    assert abs(sum(p["share"] for p in loaded.traffic["populations"])
               - 1.0) < 1e-12


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + list(CELLS) + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_entry(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_entry(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["layer"] in LAYERS and metric["moves"] in E2E
    assert set(metric["workloads"]) <= CELLS
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert hasattr(harness.load_file("metrics", metric["name"]), "read")
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


@pytest.mark.parametrize("name", ["b1", "b6", "poisson_fft", "yee_update"])
def test_rooflines_found_by_name(name):
    roof = harness.load_file("rooflines", name)
    n_bytes, flops = roof.work(1024, (8, 8))
    assert n_bytes > 0 and flops > 0


def test_step_work_and_counters_named():
    for entry in BENCH["configs"]:
        config = json.loads((harness.ROOT / entry["file"]).read_text())
        for part in config["step_work"]:
            harness.load_file("rooflines", part)
        assert config["kernel"] in config["step_work"]


def test_paths_hold_only_names():
    for path in (harness.HERE).rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
