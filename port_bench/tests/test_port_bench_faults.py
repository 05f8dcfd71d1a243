"""What ``correct`` catches, at a small size on the CPU: the
lower-precision control put in the program's place, and faults planted
in the timed path underneath a whole run (a step that leaves the state
unchanged; half of the particles left out, their charge or current made
up by doubling the rest; one particle's answer altered where the kernel
produces it; in ES, every velocity pushed a little each step).  The exchange between chips has no fault here: every cell
runs on one chip."""

import json

import pytest
import torch

from fusion_sim_torch.models import electromagnetic, electrostatic
from port_bench import harness
from port_bench.tests.tiny import run_tiny

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _model(cell):
    if cell.startswith("es2d"):
        return electrostatic, "fused_es2d_substep", electrostatic.\
            SortedElectrostaticPIC
    return electromagnetic, "fused_em3d_substep", electromagnetic.\
        SortedElectromagneticPIC


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    result, _ = run_tiny(cell, control=True)
    assert result["correct"], result["checks"]
    limits = harness.load_cell(cell).config["limits"]
    failed = [k for k, v in result["control"].items() if v > limits[k]]
    assert failed, result["control"]


def _half(orig, es):
    def substep(*args, **kw):
        args = list(args)
        pos, vel = args[1], args[2]
        keep = torch.arange(pos.shape[0]) < pos.shape[0] // 2
        if es:      # (e_grid, pos, vel, weights, tile_id, ...)
            args[3] = torch.where(keep, args[3], 0.0)
        else:       # (table, pos, vel, valid, tile_id, ...)
            args[3] = args[3] & keep
        x1, v1, grid, in_win = orig(*args, **kw)
        x1 = torch.where(keep[:, None], x1, pos)
        v1 = torch.where(keep[:, None], v1, vel)
        return x1, v1, 2.0 * grid, in_win | ~keep
    return substep


def _altered(orig):
    def substep(*args, **kw):
        x1, v1, grid, in_win = orig(*args, **kw)
        real = int(torch.nonzero(args[3] != 0)[0])    # weight or valid
        x1 = x1.clone()
        x1[real] = x1[real] + 0.25
        return x1, v1, grid, in_win
    return substep


def _drifting(orig):
    def substep(*args, **kw):
        x1, v1, grid, in_win = orig(*args, **kw)
        return x1, v1 + 1e-6, grid, in_win
    return substep


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("es2d")])
def test_slow_velocity_drift_makes_es_run_incorrect(cell, monkeypatch):
    """Every velocity pushed by 1e-6 a step (2e-5 of v_th): too little
    for one step's moments, caught by the momentum held since the
    inputs."""
    monkeypatch.setattr(electrostatic, "fused_es2d_substep",
                        _drifting(electrostatic.fused_es2d_substep))
    result, _ = run_tiny(cell)
    checks = result["checks"]
    assert checks["moments"]["value"] <= checks["moments"]["limit"]
    assert checks["momentum"]["value"] > checks["momentum"]["limit"]
    assert result["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_run_incorrect(cell, fault, monkeypatch):
    module, name, cls = _model(cell)
    orig = getattr(module, name)
    if fault == "unchanged":
        monkeypatch.setattr(cls, "step", lambda self, n=1: None)
    elif fault == "half":
        monkeypatch.setattr(module, name, _half(orig, module is
                                                electrostatic))
    else:
        monkeypatch.setattr(module, name, _altered(orig))
    result, _ = run_tiny(cell)
    assert result["correct"] is False, result["checks"]
