"""What ``correct`` catches, at a small size on the CPU: the
lower-precision control put in the program's place, and the faults that
each cell's kind plants in its timed path underneath a whole run
(``port_bench/tests/kinds/<model>.py``: a step that leaves the state
unchanged; half of the particles left out, their charge or current made
up by doubling the rest; one particle's answer altered where the kernel
produces it; in ES, every velocity pushed a little each step).  The
exchange between chips has no fault here: every cell runs on one chip."""

import json

import pytest

from port_bench import harness
from port_bench.tests import kinds
from port_bench.tests.tiny import run_tiny

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _kind_tests(cell):
    return kinds.of(harness.load_cell(cell).config["model"])


# a cell whose kind has no test module fails test_cell_has_kind_tests
TESTED = [c for c in CELLS if _kind_tests(c) is not None]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_has_kind_tests(cell):
    model = harness.load_cell(cell).config["model"]
    mod = kinds.of(model)
    assert mod is not None, \
        f"{cell}: no port_bench/tests/kinds/{model}.py (tiny and FAULTS)"
    assert callable(mod.tiny) and mod.FAULTS


@pytest.mark.parametrize("cell", TESTED)
def test_sound_run_is_correct_and_control_is_not(cell):
    result, _ = run_tiny(cell, control=True)
    assert result["correct"], result["checks"]
    limits = harness.load_cell(cell).config["limits"]
    failed = [k for k, v in result["control"].items() if v > limits[k]]
    assert failed, result["control"]


@pytest.mark.parametrize("cell", [c for c in TESTED
                                  if "drifting" in _kind_tests(c).FAULTS])
def test_slow_velocity_drift_makes_es_run_incorrect(cell, monkeypatch):
    """Every velocity pushed by 1e-6 a step (2e-5 of v_th): too little
    for one step's moments, caught by the momentum held since the
    inputs."""
    _kind_tests(cell).FAULTS["drifting"](monkeypatch)
    result, _ = run_tiny(cell)
    checks = result["checks"]
    assert checks["moments"]["value"] <= checks["moments"]["limit"]
    assert checks["momentum"]["value"] > checks["momentum"]["limit"]
    assert result["correct"] is False


# every fault of the cell's kind but "drifting", which has its test above
@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in TESTED for f in _kind_tests(c).FAULTS if f != "drifting"])
def test_fault_makes_run_incorrect(cell, fault, monkeypatch):
    _kind_tests(cell).FAULTS[fault](monkeypatch)
    result, _ = run_tiny(cell)
    assert result["correct"] is False, result["checks"]
