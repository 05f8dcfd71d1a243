"""The benchmark's plain electrostatic reference (``port_bench/reference/
pic.es_step``) against the port's sorted 3D ES shell on the CPU.

A small plasma of the configuration ``es3d-128cube-30m`` (its physics and
its limits): 16^3 cells over 2 pi, 8 particles a cell, omega_p kept at 1,
on the configuration's ``Tiling3D((8, 8, 8), 512, 2)``.
``SortedElectrostaticPIC`` on its pallas path runs kernel B5's plain
version (``fused_es3d_substep_plain``) on the layout ordered by cell.
Three steps are held against one reference step each, from the same
state: a step inside a resort window, a step that opens with the resort
(the layout rebuilt by cell), and a step in which rows leave their
window and take the exact spill patch.  Each compares the numbers that
decide the benchmark's ``correct``: ``moments`` (positions and
velocities, through their CIC moments), ``rho`` (the carried charge),
and ``charge`` and ``momentum`` held since the inputs.

The tolerances are the configuration's limits, each set between the
port's largest reading at the published size on the card and the
bfloat16 control's smallest (``limits_about``): float32 rounding of the
same sums in another order passes them, and a reference computed in
bfloat16 fails them.
"""

import copy
import json
import math

import pytest
import torch

from port_bench import harness, inputs
from port_bench.kinds import electrostatic3d as kind
from torch_ranks import one_torch_thread  # noqa: F401

CONFIG = json.loads((harness.ROOT / "port_bench/configs/"
                     "es3d-128cube-30m.json").read_text())
CELLS, LENGTH, PER_CELL = 16, 2 * math.pi, 8
SEED = 2 ** 33 + 21


def _small(margin=None):
    config = copy.deepcopy(CONFIG)
    n = CELLS ** 3 * PER_CELL
    d = LENGTH / CELLS
    config["physics"].update(grid_shape=[CELLS] * 3, cell_size=[d] * 3,
                             charge=-LENGTH ** 3 / n, mass=LENGTH ** 3 / n)
    config["n_particles"] = n
    if margin is not None:
        config["tiling"]["margin"] = margin
    return config


def _sim(config, v_thermal, seed=SEED):
    """The shell built from the benchmark's generator, and its inputs."""
    traffic = {"layout": "resort",
               "populations": [{"share": 1.0, "v_thermal": v_thermal}]}
    x, v = inputs.make(config, traffic, seed, "cpu")
    sim = kind.build(config, config["layouts"]["resort"], x.numpy(),
                     v.numpy(), "cpu")
    return sim, x, v


def _numbers(config, after, ref, before, x_in, v_in):
    out = kind.step_numbers(config, after, ref, before)
    out.update(kind.end_numbers(config, after, x_in, v_in))
    return out


def _check(config, sim, x_in, v_in):
    """One ``step(1)`` held against the reference from the same state;
    the rows it patched."""
    before, spill0 = kind.snapshot(sim), sim.state.spill
    sim.step(1)
    assert kind.dropped(sim) == 0
    after = kind.snapshot(sim)
    ref = kind.reference_after(config, before)
    numbers = _numbers(config, after, ref, before, x_in, v_in)
    limits = config["limits"]
    assert set(numbers) == {"count", "moments", "rho", "charge", "momentum"}
    for k, value in numbers.items():
        assert value <= limits[k], (k, value)
    # the step moved the plasma: a state left as it was fails by far
    still = kind.step_numbers(config, before, ref, before)
    assert still["moments"] > 10 * limits["moments"]
    return sim.state.spill - spill0


@pytest.mark.parametrize("calls_before", [2, 6], ids=["inside", "resort"])
def test_port_step_matches_reference(calls_before):
    """A step inside the window of 6, and the 7th call, which opens with
    the resort by cell."""
    config = _small()
    sim, x_in, v_in = _sim(config, 0.05)
    for _ in range(calls_before):
        sim.step(1)
    resorts = sim._since_sort >= sim.resort_every
    assert resorts == (calls_before == 6)
    _check(config, sim, x_in, v_in)


def test_spilled_rows_take_the_patch_and_match_reference():
    """A hot plasma (v_th 2: 0.25 cells a step) with a one-cell margin:
    rows leave their window from the first steps; the step held against
    the reference patches some of them exactly."""
    config = _small(margin=1)
    sim, x_in, v_in = _sim(config, 2.0)
    for _ in range(3):
        sim.step(1)
    assert _check(config, sim, x_in, v_in) > 0


def test_bfloat16_reference_fails():
    config = _small()
    sim, x_in, v_in = _sim(config, 0.05, seed=5)
    sim.step(2)
    before = kind.snapshot(sim)
    ref = kind.reference_after(config, before)
    low = kind.reference_after(config, before, torch.bfloat16)
    numbers = _numbers(config, low, ref, before, x_in, v_in)
    limits = config["limits"]
    assert [k for k, v in numbers.items() if v > limits[k]], numbers
