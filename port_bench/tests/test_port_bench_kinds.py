"""A kind of model comes as files of its own: a stub kind that lives only
in this file (a 2D free-streaming plasma loaded into a corner box of the
grid, ``port_bench.kinds.freestream_stub``, with its test module under
the same name) runs through the harness on an existing cell's traffic
with its own load, its own small size and its own faults; and the ES and
EM kinds, which define no load of their own, get ``inputs.make``'s."""

import importlib
import json
import sys
import types

import numpy as np
import pytest
import torch

from port_bench import check, harness, inputs
from port_bench.tests.tiny import run_tiny

STUB = "freestream_stub"
CELL = "es2d-512sq-10m.thermal-resort"     # its traffic: v_th 0.05, resort
SEED = 2 ** 33 + 17
CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
BOX = 0.25          # the load's corner box, a share of each axis
N_TINY = 4096

CONFIG = {
    "model": STUB,
    "n_particles": 10 ** 6,
    "velocity_components": 2,
    "physics": {"grid_shape": [32, 32], "dt": 10.0},
    "kernel_counter": f"port_bench.kinds.{STUB}",
    "layouts": {"resort": {"shell": {"resort_every": 4},
                           "warmup_steps": 2, "trace_steps": 2}},
    "limits": {"count": 0, "dropped": 0, "nonfinite": 0, "start": 1e-6,
               "moments": 1e-6},
}


class FreeStream:
    """x <- (x + dt v) mod n, a step at a time; no fields."""

    def __init__(self, x, v, shape, dt):
        self.x, self.v, self.dt = x, v, dt
        self.extent = torch.tensor(shape, dtype=torch.float32,
                                   device=x.device)

    def step(self, n=1):
        for _ in range(n):
            self.x = torch.remainder(self.x + self.dt * self.v, self.extent)


def _kind(built: dict) -> types.ModuleType:
    K = types.ModuleType(f"port_bench.kinds.{STUB}")
    K.LAUNCHES = 0

    def kind_inputs(config, traffic, seed, device):
        n = int(config["n_particles"])
        shape = config["physics"]["grid_shape"]
        g = torch.Generator(device=device)
        g.manual_seed(int(seed) % (1 << 64))
        extent = torch.tensor(shape, dtype=torch.float32, device=device)
        x = BOX * extent * torch.rand((n, len(shape)), generator=g,
                                      device=device)
        v = traffic["populations"][0]["v_thermal"] * torch.randn(
            (n, int(config["velocity_components"])), generator=g,
            device=device)
        return x, v

    def build(config, layout, pos, vel, device):
        built["pos"] = pos.copy()
        return FreeStream(torch.as_tensor(pos, device=device),
                          torch.as_tensor(vel, device=device),
                          config["physics"]["grid_shape"],
                          config["physics"]["dt"])

    def reference_after(config, before, fdtype=torch.float32):
        shape = config["physics"]["grid_shape"]
        extent = torch.tensor(shape, dtype=torch.float32,
                              device=before["x"].device)
        v = before["v"].to(fdtype).float()
        return {"x": torch.remainder(
            before["x"] + config["physics"]["dt"] * v, extent), "v": v}

    def step_numbers(config, after, ref, before):
        return check.rows_gap(after, ref["x"], ref["v"],
                              config["physics"]["grid_shape"],
                              int(config["n_particles"]))

    K.inputs = kind_inputs
    K.build = build
    K.snapshot = lambda sim: {"x": sim.x.clone(), "v": sim.v.clone()}
    K.dropped = lambda sim: 0
    K.reference_after = reference_after
    K.step_numbers = step_numbers
    K.end_numbers = lambda config, end, x_in, v_in: {}
    return K


def _half_step(self, n=1):
    h = self.x.shape[0] // 2
    for _ in range(n):
        moved = torch.remainder(self.x + self.dt * self.v, self.extent)
        self.x = torch.cat([moved[:h], self.x[h:]])


_STREAM = FreeStream.step      # the sound step, kept from the faults


def _altered_step(self, n=1):
    _STREAM(self, n)
    self.x = self.x.clone()
    self.x[0] = self.x[0] + 0.25


def _kind_tests() -> types.ModuleType:
    T = types.ModuleType(f"port_bench.tests.kinds.{STUB}")

    def tiny(config):
        config["n_particles"] = N_TINY
        return config

    T.tiny = tiny
    T.FAULTS = {
        "unchanged": lambda mp: mp.setattr(FreeStream, "step",
                                           lambda self, n=1: None),
        "half": lambda mp: mp.setattr(FreeStream, "step", _half_step),
        "altered": lambda mp: mp.setattr(FreeStream, "step", _altered_step),
    }
    return T


@pytest.fixture
def stub(monkeypatch):
    """The stub kind and its test module, found by name like any other;
    what its ``build`` got."""
    built = {}
    monkeypatch.setitem(sys.modules, f"port_bench.kinds.{STUB}",
                        _kind(built))
    monkeypatch.setitem(sys.modules, f"port_bench.tests.kinds.{STUB}",
                        _kind_tests())
    return built


def test_stub_kind_runs_with_its_own_load(stub):
    result, _ = run_tiny(CELL, seed=SEED, config=CONFIG)
    assert result["correct"] is True, result["checks"]
    # its tiny was found by the model's name
    assert stub["pos"].shape == (N_TINY, 2)
    # set-up built the stub's load: every row in the corner box ...
    assert (stub["pos"] < BOX * 32).all()
    # ... and start held it to the stub's load drawn again, which
    # inputs.make's plasma, uniform over the grid, would fail by far
    start = result["checks"]["start"]
    assert start["value"] <= start["limit"]
    small = dict(CONFIG, n_particles=N_TINY)
    traffic = harness.load_cell(CELL).traffic
    own = harness.particle_load(harness.kind(small), small, traffic, SEED,
                                "cpu")
    common = inputs.make(small, traffic, SEED, "cpu")
    shape = small["physics"]["grid_shape"]
    assert check.gap(check.moments(*common, shape),
                     check.moments(*own, shape)) > 100 * start["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_stub_kind_faults_make_run_incorrect(stub, fault, monkeypatch):
    from port_bench.tests import kinds

    faults = kinds.of(STUB).FAULTS
    assert set(faults) == {"unchanged", "half", "altered"}
    faults[fault](monkeypatch)
    result, _ = run_tiny(CELL, seed=SEED, config=CONFIG)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("model", ["electrostatic", "electromagnetic"])
def test_es_and_em_draw_from_the_common_generator(model, monkeypatch):
    """No ``inputs`` of their own: set-up builds from ``inputs.make``'s
    draws for the seed, bit for bit."""
    K = importlib.import_module(f"port_bench.kinds.{model}")
    assert not hasattr(K, "inputs")
    cell = next(c for c in CELLS
                if harness.load_cell(c).config["model"] == model)
    built = {}
    orig = K.build

    def build(config, layout, pos, vel, device):
        built.update(config=config, pos=pos.copy(), vel=vel.copy())
        return orig(config, layout, pos, vel, device)

    monkeypatch.setattr(K, "build", build)
    result, _ = run_tiny(cell, seed=SEED)
    assert result["correct"] is True, result["checks"]
    x, v = inputs.make(built["config"], harness.load_cell(cell).traffic,
                       SEED, "cpu")
    assert np.array_equal(built["pos"], x.numpy())
    assert np.array_equal(built["vel"], v.numpy())
