"""Port vs reference: the sharded examples
(``fusion_sim_torch/examples/bench_sharded_1chip.py`` and
``bench_weak_scaling.py``), on the CPU at tiny sizes.

``bench_sharded_1chip.build_sim`` is held against the rung the reference's
script builds from the same flags (its model classes stubbed to record
their arguments, so nothing of the reference runs): the same configuration
field by field and the same particles.  Each example's ``main`` then runs
once with the plain versions: the one-chip bench in a world of one
(gloo), the weak-scaling bench in a gloo world of its own for each
count."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from fusion_sim_torch.examples import bench_sharded_1chip, bench_weak_scaling


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test (the suite runs several test processes
    side by side)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class _Recorder:
    """Stands in for a reference model class: keeps its arguments."""

    made = []

    def __init__(self, config, mesh, position, velocity):
        _Recorder.made.append((config, position, velocity))


def _reference_rung(monkeypatch, argv):
    """(config, positions, velocities) the reference's script builds."""
    import examples.bench_sharded_1chip as ref
    from fusion_sim_tpu.models import electromagnetic_sharded2d as em2d
    from fusion_sim_tpu.models import electrostatic_sharded2d as es2d

    _Recorder.made = []
    for mod, name in ((ref, "ShardedElectrostaticPIC"),
                      (ref, "ShardedElectromagneticPIC"),
                      (es2d, "ShardedElectrostaticPIC2D"),
                      (em2d, "ShardedElectromagneticPIC2D")):
        monkeypatch.setattr(mod, name, _Recorder)
    monkeypatch.setattr(ref, "bench", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["bench_sharded_1chip.py", *argv])
    ref.main()
    (made,) = _Recorder.made
    return made


def _fields(config):
    """A config's fields, its base and tiling as dicts of their fields."""
    out = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif hasattr(v, "_asdict"):
            v = v._asdict()
        elif hasattr(v, "__dict__") and f.name == "tiling":
            v = {k: getattr(v, k) for k in vars(v)}
        out[f.name] = v
    return out


def _rows(pos, vel):
    rows = np.concatenate([pos, vel], axis=1)
    return rows[np.lexsort(rows[:, ::-1].T)]


SMALL = ["--n", "8192", "--steps", "2"]
RUNGS = {
    "em": ["--model", "em", "--cells", "64"],
    "em3d": ["--model", "em", "--dim", "3", "--cells", "16"],
    "em_repair": ["--model", "em", "--repair", "--cells", "64"],
    "es": ["--model", "es", "--cells", "64"],
    "es_repair_eager": ["--model", "es", "--repair", "--eager", "2",
                        "--cells", "64"],
    "mesh2d_em": ["--model", "em", "--mesh2d", "--cells", "64"],
    "mesh2d_es3d": ["--model", "es", "--mesh2d", "--dim", "3", "--cells",
                    "16"],
}


@pytest.mark.parametrize("rung", list(RUNGS))
def test_sharded_1chip_builds_the_reference_rung(monkeypatch, rung):
    """The port's sharded model at each rung carries the reference
    script's configuration (every field, the base's and the tiling's) and
    the same particles."""
    argv = RUNGS[rung] + SMALL
    ref_cfg, ref_pos, ref_vel = _reference_rung(monkeypatch, argv)
    args = bench_sharded_1chip.parse_args(argv + ["--device", "cpu"])
    sim, _, _ = bench_sharded_1chip.build_sim(args)
    try:
        assert _fields(sim.config) == _fields(ref_cfg)
        np.testing.assert_array_equal(_rows(*sim.gather_particles()),
                                      _rows(ref_pos, ref_vel))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


@pytest.mark.parametrize("argv", [
    ["--model", "em", "--cells", "64"],
    ["--model", "em", "--mesh2d", "--cells", "64"],
    ["--model", "es", "--mesh2d", "--dim", "3", "--cells", "16"],
], ids=["em", "mesh2d_em", "mesh2d_es3d"])
def test_sharded_1chip_main_prints_its_lines(argv, capsys):
    """``main`` times the sharded model and the single-device fused model
    at the same rung in a world of one it starts and ends, and prints
    both lines and their ratio; nothing overflows or drops."""
    import torch.distributed as dist

    res = bench_sharded_1chip.main(argv + SMALL + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "ms/step" in out and "ratio sharded / single-device" in out
    assert ("sharded2d" in out) == ("--mesh2d" in argv)
    assert np.isfinite(res["ratio"]) and res["ratio"] > 0
    assert res["overflow"] == 0 and res["dropped"] == 0
    assert not dist.is_initialized()


def test_weak_scaling_runs_each_count_in_its_own_world(capfd):
    """Counts 1 and 2 in gloo worlds of 1 and 2 CPU ranks: the three
    models' rows at each, the ES phases (printed by the spawned rank 0),
    and the summary table."""
    rows = bench_weak_scaling.main(
        ["--devices", "1", "2", "--cpu", "--per-device", "2048",
         "--cells-x-per-device", "16", "--cells-y", "32", "--steps", "2",
         "--phases"])
    out = capfd.readouterr().out
    assert [(r[0], r[1]) for r in rows] == [
        (label, nd) for nd in (1, 2)
        for label in ("em-packed", "em-sorted", "es-fft")]
    assert all(np.isfinite(r[2]) and r[2] > 0 for r in rows)
    assert "es phases nd=2" in out and "migrate=" in out
    assert "weak scaling summary" in out
