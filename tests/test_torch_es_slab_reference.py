"""The benchmark's plain electrostatic reference (``port_bench/reference/
pic.es_step``) against the port's sharded 3D ES shell in a world of one,
on the CPU.

A small slab of the configuration ``es3d-slab512-125m`` (its physics,
tiling and limits): 16 x 32 x 32 cells of a 128^3 grid over 2 pi (the
configuration's cell shape, omega_p kept at 1), 4 particles a cell, on
the configuration's ``Tiling3D((8, 16, 16), 512, 2)``.
``ShardedElectrostaticPIC`` on its pallas path in a ring of one runs
kernel B5's plain version (``fused_es3d_substep_plain``) on the shard's
halo-padded pseudo-grid (32 x 32 x 32: the slab and a halo of 8 cells a
side), rows by cell.  With one shard the slab is the periodic box, so
one reference step from the same state is the answer.  Three steps are
held against it: a step inside a resort window, the step that opens with
the resort, and a step in which rows leave their window and take the
exact spill patch while others cross both x faces, which the ring of one
wraps onto its own opposite face.  Each compares the numbers that decide
the benchmark's ``correct`` (``moments``, ``rho``, ``charge``,
``momentum``, ``overflow``) under the configuration's limits; a
reference computed in bfloat16 fails them.

The world of one is a gloo world in a process of its own
(``torch_ranks.run_world``), so that no process group outlives the test
in the pytest process.
"""

import copy
import json
import math

import pytest

from port_bench import harness
from torch_ranks import one_torch_thread, run_world  # noqa: F401

CONFIG = json.loads((harness.ROOT / "port_bench/configs/"
                     "es3d-slab512-125m.json").read_text())
SHAPE, PER_CELL = [16, 32, 32], 4
SEED = 2 ** 33 + 31
# the hot plasma of the spill case: 0.25 cells a step (v_th dt / dx)
V_HOT = 0.25 * (2 * math.pi / 128) / 0.05


def _small():
    config = copy.deepcopy(CONFIG)
    n = math.prod(SHAPE) * PER_CELL
    d = 2 * math.pi / 128
    vol = math.prod(SHAPE) * d ** 3
    config["physics"].update(grid_shape=SHAPE, cell_size=[d] * 3,
                             charge=-vol / n, mass=vol / n)
    config["n_particles"] = n
    config["shell"].update(capacity=n, migration_buffer=1024)
    config["layouts"]["resort"]["shell"]["spill_capacity"] = n
    return config


def slab_body(rank, inp):
    """In the world of one: each case's numbers against the reference, the
    rows it patched and the rows that crossed an x face."""
    import torch

    from port_bench import inputs
    from port_bench.kinds import electrostatic3d_sharded as kind

    config = inp["config"]
    cadence = config["layouts"]["resort"]["shell"]["resort_every"]

    def sim_of(v_thermal, seed):
        traffic = {"layout": "resort",
                   "populations": [{"share": 1.0, "v_thermal": v_thermal}]}
        x, v = inputs.make(config, traffic, seed, "cpu")
        return kind.build(config, config["layouts"]["resort"], x.numpy(),
                          v.numpy(), "cpu"), x, v

    def numbers(after, ref, before, x_in, v_in):
        out = kind.step_numbers(config, after, ref, before)
        out.update(kind.end_numbers(config, after, x_in, v_in))
        return out

    def case(v_thermal, calls_before, seed=SEED):
        sim, x_in, v_in = sim_of(v_thermal, seed)
        for _ in range(calls_before):
            sim.step(1)
        resorts = sim._since_sort >= cadence
        before = kind.snapshot(sim)
        x0 = sim.state.position.clone()
        spill0 = int(sim.state.spill.sum())
        sim.step(1)
        after = kind.snapshot(sim)
        ref = kind.reference_after(config, before)
        # rows keep their slots in a step that does not resort: those whose
        # x jumped by more than half the slab crossed a face, the upper one
        # where it fell
        dx = sim.state.position[:, 0] - x0[:, 0]
        crossed = None if resorts else [
            int((sim.state.alive & (sign * dx > SHAPE[0] / 2)).sum())
            for sign in (1, -1)]
        low = kind.reference_after(config, before, torch.bfloat16)
        return {"resorts": resorts, "dropped": kind.dropped(sim),
                "numbers": numbers(after, ref, before, x_in, v_in),
                "still": kind.step_numbers(config, before, ref, before),
                "control": numbers(low, ref, before, x_in, v_in),
                "patched": int(sim.state.spill.sum()) - spill0,
                "crossed": crossed}

    return {"inside": case(0.05, 2), "resort": case(0.05, cadence),
            "spill": case(V_HOT, cadence - 1)}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    config = _small()
    out = run_world(1, slab_body, {"config": config},
                    tmp_path_factory.mktemp("slab"))[0]
    return config, out


@pytest.mark.parametrize("name", ["inside", "resort", "spill"])
def test_port_step_matches_reference(cases, name):
    """A step inside the resort window, the call after the window, which
    opens with the resort by cell, and a hot step, the last of its
    window."""
    config, out = cases
    got = out[name]
    assert got["resorts"] == (name == "resort")
    assert got["dropped"] == 0
    limits = config["limits"]
    assert set(got["numbers"]) == {"count", "moments", "rho", "charge",
                                   "momentum", "overflow"}
    for k, value in got["numbers"].items():
        assert value <= limits[k], (name, k, value)
    # the step moved the plasma: a state left as it was fails by far
    assert got["still"]["moments"] > 10 * limits["moments"]


def test_spilled_rows_cross_both_faces(cases):
    """The hot step patched rows exactly and wrapped rows over each x face
    (the lower, the upper) through the ring of one."""
    got = cases[1]["spill"]
    assert got["patched"] > 0
    assert min(got["crossed"]) > 0, got["crossed"]


def test_bfloat16_reference_fails(cases):
    config, out = cases
    limits = config["limits"]
    for name, got in out.items():
        failed = [k for k, v in got["control"].items() if v > limits[k]]
        assert failed, (name, got["control"])
