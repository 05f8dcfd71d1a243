"""Port vs reference: the sharded ES model (counterparts of
tests/test_es_sharded.py), each case against the reference's same function
at the same number of shards.

One gloo world of four ranks runs every case of the file
(``torch_ranks.es_body``): rings of four, rings of two (ranks (0, 1) and
(2, 3) run different cases at once) and single shards.  The reference runs
in this process on meshes of the same sizes over its fake CPU devices.

How each case compares (``torch.sort`` is stable and the reference's
``lax.sort`` is not, so layouts after a sort agree per tile segment as
sets, and from there migration and repair pick other slots):
* the constructor's layout: tile ids and validity exactly, each tile
  segment's rows as a set;
* ``steps`` steps from the reference's own initial state
  (``ShardedElectrostaticPIC.from_state``), with no resort between: row
  for row, the counts (``spill``, ``overflow``, ``unplaced``, the stack
  depths) exactly, values to f32 rounding;
* ``more`` single ``step(1)`` calls after those, through the shells'
  cadence (resorts included): the live particles as a set, matched to the nearest row, and
  the overflow exactly.
"""

import warnings

import numpy as np
import pytest
from scipy.spatial import cKDTree

from torch_ranks import es_body, run_world

TWO_PI = 2 * np.pi


def _base(n_cells, n, ndim=2, spread=True):
    d = TWO_PI / n_cells
    vol = TWO_PI ** ndim if spread else 1.0
    return dict(grid_shape=(n_cells,) * ndim, cell_size=(d,) * ndim,
                dt=0.05, charge=-vol / n, mass=vol / n)


def _particles(n, n_cells, ndim, seed, vscale, drift=None):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, ndim)) * n_cells).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, ndim))).astype(np.float32)
    if drift is not None:
        vel[:, 0] += drift
    return pos, vel


def _tiling2d():
    return dict(tile_r=8, tile_z=8, block=128, margin=2)


def _clustered():
    """tests/test_es_sharded.py's flood: every particle in one slab,
    drifting right fast."""
    rng = np.random.default_rng(3)
    n = 2000
    pos = np.zeros((n, 2), np.float32)
    pos[:, 0] = 6.0 + rng.random(n).astype(np.float32)
    pos[:, 1] = (rng.random(n) * 64).astype(np.float32)
    vel = (0.05 * rng.standard_normal((n, 2))).astype(np.float32)
    vel[:, 0] += 1.9
    return pos, vel


def _cases():
    """Every case: its ring, configuration, particles, steps."""
    pos4k, vel4k = _particles(4000, 64, 2, 0, 0.1)
    drift_pos, drift_vel = _particles(4000, 64, 2, 0, 0.1, drift=0.8)
    eager_pos, eager_vel = _particles(4000, 64, 2, 1, 0.1, drift=0.6)
    flood_pos, flood_vel = _clustered()
    repair2d = dict(base=_base(64, 4000, spread=False), n_shards=4,
                    capacity=1536, migration_buffer=128, tiling=_tiling2d(),
                    resort_every=10 ** 6, repair=True)
    return [
        # tests/test_es_sharded.py:35-52 (the plain composition)
        dict(name="plain", n_shards=4, config=dict(
            base=_base(64, 4000), n_shards=4, capacity=2048,
            migration_buffer=128),
            data=_particles(4000, 64, 2, 0, 0.05), steps=6),
        # :55-78, a cloud crossing several slab boundaries
        dict(name="roundtrip", n_shards=4, config=dict(
            base=_base(64, 1000), n_shards=4, capacity=1024,
            migration_buffer=256),
            data=_particles(1000, 64, 2, 3, 0.05, drift=1.2), steps=40),
        # :81-102, debug_checks raising on fast particles
        dict(name="debug", n_shards=4, config=dict(
            base=_base(64, 1000), n_shards=4, capacity=1024,
            migration_buffer=256, debug_checks=True),
            data=_particles(1000, 64, 2, 5, 0.05, drift=40.0), steps=1,
            expect_raise=True),
        # :105-143, the sorted 2D composition (backend 'xla')
        dict(name="sorted2d", n_shards=4, from_state=True, config=dict(
            base=_base(64, 4000, spread=False), n_shards=4, capacity=1536,
            migration_buffer=64, tiling=_tiling2d(), resort_every=4),
            data=(pos4k, vel4k), steps=3, more=5),
        # :317-383 (xla) repair with the resort off under sustained drift
        dict(name="repair2d", n_shards=4, from_state=True, config=repair2d,
             data=(drift_pos, drift_vel), steps=6, more=4),
        # :386-433 / :520-569, eager repair
        dict(name="eager2d", n_shards=4, from_state=True,
             config=dict(repair2d, migration_buffer=64, repair_eager=1),
             data=(eager_pos, eager_vel), steps=6, more=2),
        # :472-517, dropped arrivals warn and schedule a resort
        dict(name="overflow", n_shards=4, from_state=True, config=dict(
            base=_base(64, 2000, spread=False), n_shards=4, capacity=2048,
            migration_buffer=2048, tiling=_tiling2d(), resort_every=10 ** 6,
            repair=True, repair_free_slots=4, spare_slots=4),
            data=(flood_pos, flood_vel), steps=1, more=9),
        # :146-193, backend 'pallas' in 2D (B1's plain version here, the
        # reference's kernel in interpret mode), on two shards
        dict(name="pallas2d", n_shards=2, ranks=(0, 1), from_state=True,
             config=dict(base=_base(32, 2048, spread=False), n_shards=2,
                         capacity=1280, migration_buffer=64,
                         tiling=_tiling2d(), resort_every=4,
                         backend="pallas"),
             data=_particles(2048, 32, 2, 4, 0.1), steps=3, more=5),
        # :317-383 (pallas), repair on the fused composition
        dict(name="repair_pallas2d", n_shards=2, ranks=(0, 1),
             from_state=True, config=dict(
                 base=_base(32, 2048, spread=False), n_shards=2,
                 capacity=1280, migration_buffer=128, tiling=_tiling2d(),
                 resort_every=10 ** 6, backend="pallas", repair=True),
             data=_particles(2048, 32, 2, 0, 0.1, drift=0.8), steps=4,
             more=2),
        # :239-280, backend 'pallas' in 3D (B5), two shards
        dict(name="pallas3d", n_shards=2, ranks=(2, 3), from_state=True,
             config=dict(base=_base(16, 1024, 3, spread=False), n_shards=2,
                         capacity=768, migration_buffer=64,
                         tiling=dict(tile=(4, 4, 4), block=128, margin=1),
                         resort_every=3, backend="pallas"),
             data=_particles(1024, 16, 3, 6, 0.1), steps=2, more=4),
        # :196-236 (3D sorted, xla) and :436-469 (3D repair), two shards
        dict(name="sorted3d", n_shards=2, ranks=(2, 3), from_state=True,
             config=dict(base=_base(16, 2048, 3, spread=False), n_shards=2,
                         capacity=1280, migration_buffer=64,
                         tiling=dict(tile=(4, 4, 4), block=128, margin=1),
                         resort_every=3),
             data=_particles(2048, 16, 3, 2, 0.1), steps=2, more=4),
        dict(name="repair3d", n_shards=2, ranks=(2, 3), from_state=True,
             config=dict(base=_base(16, 2048, 3, spread=False), n_shards=2,
                         capacity=1280, migration_buffer=128,
                         tiling=dict(tile=(4, 4, 4), block=128, margin=1),
                         resort_every=10 ** 6, repair=True),
             data=_particles(2048, 16, 3, 2, 0.1, drift=2.0), steps=4,
             more=2),
        # :283-314, one shard (its ring is the rank itself)
        dict(name="single", n_shards=1, ranks=(0,), from_state=True,
             config=dict(base=_base(32, 2000, spread=False), n_shards=1,
                         capacity=2048, migration_buffer=64,
                         tiling=_tiling2d(), resort_every=4),
             data=_particles(2000, 32, 2, 1, 0.1), steps=3, more=5),
        dict(name="single_pallas", n_shards=1, ranks=(1,), from_state=True,
             config=dict(base=_base(32, 2048, spread=False), n_shards=1,
                         capacity=2048, migration_buffer=64,
                         tiling=_tiling2d(), resort_every=4,
                         backend="pallas"),
             data=_particles(2048, 32, 2, 7, 0.1), steps=3, more=5),
    ]


def _jax_config(config):
    from fusion_sim_tpu.models import electrostatic as jes
    from fusion_sim_tpu.models.electrostatic_sharded import ShardedESConfig
    from fusion_sim_tpu.ops.sorted_deposit import Tiling2D, Tiling3D

    kw = dict(config)
    base = jes.ESConfig(**kw.pop("base"))
    tiling = kw.pop("tiling", None)
    if tiling is not None:
        tiling = (Tiling2D(**tiling) if "tile_r" in tiling
                  else Tiling3D(**tiling))
    return ShardedESConfig(base=base, tiling=tiling, **kw)


def _jax_sim(case):
    from fusion_sim_tpu.models.electrostatic_sharded import (
        ShardedElectrostaticPIC)
    from fusion_sim_tpu.parallel.mesh import make_mesh

    pos, vel = case["data"]
    return ShardedElectrostaticPIC(_jax_config(case["config"]),
                                   make_mesh(case["n_shards"], ("space",)),
                                   pos, vel)


def _state(sim):
    return {k: np.asarray(v) for k, v in sim.state._asdict().items()
            if v is not None}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, sims = [], {}
    for case in _cases():
        case = dict(case)
        case["position"], case["velocity"] = case.pop("data")
        if case.pop("from_state", False):
            sims[case["name"]] = sim = _jax_sim(
                dict(case, data=(case["position"], case["velocity"])))
            case["initial"] = _state(sim)
        cases.append(case)
    ranks = run_world(4, es_body, {"cases": cases},
                      tmp_path_factory.mktemp("es_sharded"))
    return {"ranks": ranks, "cases": {c["name"]: c for c in cases},
            "sims": sims}


def _ring(world, name):
    """The results of one case, in shard order."""
    case = world["cases"][name]
    ranks = case.get("ranks") or range(case["n_shards"])
    return [world["ranks"][r][name] for r in ranks]


def _stack(parts, key):
    return np.concatenate([p[key] for p in parts])


def _match(got, want, atol):
    """Each live particle of ``got`` (positions, velocities) has its own
    nearest reference row, within ``atol`` in every coordinate."""
    assert got[0].shape == want[0].shape
    rows_g = np.concatenate(got, axis=1)
    rows_w = np.concatenate(want, axis=1)
    _, idx = cKDTree(want[0]).query(got[0])
    assert len(np.unique(idx)) == len(idx)
    np.testing.assert_allclose(rows_g, rows_w[idx], rtol=0, atol=atol)


def _segments(state, ndim):
    """{tile: the segment's live rows, sorted} of a layout."""
    tid, alive = state["tile_id"], state["alive"]
    rows = np.concatenate([state["position"], state["velocity"]], axis=1)
    out = {}
    for t in np.unique(tid[alive]):
        seg = rows[(tid == t) & alive]
        out[int(t)] = seg[np.lexsort(seg[:, ::-1].T)]
    return out


def _check_built(world, name):
    """The constructors' layouts: same tile ids and validity, each tile
    segment the same set of rows."""
    case = world["cases"][name]
    ref = world["sims"][name]
    ndim = len(case["config"]["base"]["grid_shape"])
    init = case["initial"]
    cap = init["position"].shape[0] // case["n_shards"]
    for s, part in enumerate(_ring(world, name)):
        got = part["built"]
        sl = slice(s * cap, (s + 1) * cap)
        np.testing.assert_array_equal(got["tile_id"], init["tile_id"][sl])
        np.testing.assert_array_equal(got["alive"], init["alive"][sl])
        want = _segments({k: init[k][sl] for k in
                          ("tile_id", "alive", "position", "velocity")},
                         ndim)
        have = _segments(got, ndim)
        assert have.keys() == want.keys()
        for t in want:
            np.testing.assert_array_equal(have[t], want[t])
    return ref


def _check_stepped(world, name, atol=1e-5, rho_tol=1e-5):
    """``steps`` steps from the reference's initial state, row for row."""
    case = world["cases"][name]
    ref = world["sims"][name]
    for _ in range(case["steps"]):
        if case["config"].get("repair"):
            ref.step(1)
        else:
            ref.state = ref._step(ref.state)
    want = _state(ref)
    parts = [p["stepped"] for p in _ring(world, name)]
    for key in ("alive", "tile_id", "overflow", "spill", "unplaced",
                "free_cnt", "free_idx", "spare_cnt", "spare_idx"):
        if key in want:
            np.testing.assert_array_equal(_stack(parts, key), want[key],
                                          err_msg=key)
    alive = want["alive"]
    for key in ("position", "velocity"):
        got = _stack(parts, key)
        np.testing.assert_allclose(got[alive], want[key][alive], rtol=0,
                                   atol=atol, err_msg=key)
        np.testing.assert_array_equal(got[~alive], 0.0)
    np.testing.assert_allclose(_stack(parts, "max_disp"), want["max_disp"],
                               rtol=1e-5)
    if "rho" in want:
        scale = np.abs(want["rho"]).max()
        rho = _stack(parts, "rho")
        np.testing.assert_allclose(rho, want["rho"], rtol=0,
                                   atol=rho_tol * scale)
        # the carried rho is the deposit at the current positions
        seed = np.concatenate([p["seed_rho"] for p in _ring(world, name)])
        np.testing.assert_allclose(rho, seed, rtol=0, atol=rho_tol * scale)
    return ref


def _check_final(world, name, ref, atol):
    """``more`` shell steps on: the live particles as a set, the overflow
    per shard exactly."""
    case = world["cases"][name]
    for _ in range(case.get("more", 0)):   # one compiled step at a time
        ref.step(1)
    parts = _ring(world, name)
    got = parts[0]["particles"]
    for p in parts[1:]:            # every rank gathers the same particles
        for a, b in zip(p["particles"], got):
            np.testing.assert_array_equal(a, b)
    _match(got, ref.gather_particles(), atol)
    np.testing.assert_array_equal(
        np.concatenate([p["final"]["overflow"] for p in parts]),
        np.asarray(ref.state.overflow))
    inv = ref.check_invariants()
    for p in parts:
        assert p["invariants"]["overflow"] == inv["overflow"]
        assert p["invariants"]["disp_bound_ok"] == inv["disp_bound_ok"]
        np.testing.assert_allclose(p["invariants"]["max_disp_cells"],
                                   inv["max_disp_cells"], rtol=1e-5)


def _constructor_run(world, name, atol):
    """The plain composition from positions in both packages."""
    case = world["cases"][name]
    ref = _jax_sim(dict(case, data=(case["position"], case["velocity"])))
    ref.step(case["steps"])
    parts = _ring(world, name)
    _match(parts[0]["particles"], ref.gather_particles(), atol)
    assert parts[0]["invariants"]["overflow"] == \
        ref.check_invariants()["overflow"] == 0
    assert parts[0]["invariants"]["disp_bound_ok"]
    return ref


def test_poisson_fft_sharded_matches_single_device_and_reference(world):
    """The pencil solve on rings of four and two, 2D and 3D, against the
    single-device solve (both packages' tolerance, 1e-5) and the
    reference's sharded solve on a mesh of the same size."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from fusion_sim_tpu.ops.solvers import poisson_fft_sharded
    from fusion_sim_tpu.parallel.mesh import make_mesh

    for n in (4, 2):
        for shape, dx in (((64, 64), (0.5, 0.25)),
                          ((32, 64, 16), (0.5, 0.25, 1.0))):
            rho = np.random.default_rng(1).standard_normal(shape).astype(
                np.float32)
            rho -= rho.mean()
            f = shard_map(lambda r: poisson_fft_sharded(r, shape, dx,
                                                        "space"),
                          mesh=make_mesh(n, ("space",)), in_specs=P("space"),
                          out_specs=P("space"))
            ref = np.asarray(jax.jit(f)(jnp.asarray(rho)))
            slab = shape[0] // n
            for s in range(n):
                got, single = world["ranks"][s][("poisson", n, len(shape))]
                np.testing.assert_allclose(got, single, atol=1e-5)
                np.testing.assert_allclose(got, ref[s * slab:(s + 1) * slab],
                                           atol=1e-5)


def test_sharded_es_plain_matches_reference(world):
    """The plain composition, six steps on four shards: the same live
    particles to 1e-4 cells (the gathered dense-DFT solves of the two
    packages differ at f32 rounding), nothing overflows."""
    _constructor_run(world, "plain", 1e-4)


def test_sharded_es_migration_roundtrip(world):
    """A cloud drifting ~15 cells over 40 steps crosses two slab
    boundaries of four shards and survives, matching the reference to
    1e-3 (rounding grows over 40 steps)."""
    _constructor_run(world, "roundtrip", 1e-3)
    parts = _ring(world, "roundtrip")
    assert parts[0]["particles"][0].shape[0] == 1000


def test_sharded_es_debug_checks_raises_on_fast_particles(world):
    """``debug_checks`` turns a displacement past ``disp_bound`` into a
    RuntimeError on every rank, as the reference's shell raises."""
    case = world["cases"]["debug"]
    ref = _jax_sim(dict(case, data=(case["position"], case["velocity"])))
    with pytest.raises(RuntimeError, match="migration invariant violated"):
        ref.step(1)
    for part in _ring(world, "debug"):
        assert "migration invariant violated" in part["raised"]


def test_sharded_sorted_es_2d_matches_reference(world):
    ref = _check_built(world, "sorted2d")
    _check_stepped(world, "sorted2d")
    _check_final(world, "sorted2d", ref, 1e-4)


def test_sharded_sorted_es_3d_matches_reference(world):
    ref = _check_built(world, "sorted3d")
    _check_stepped(world, "sorted3d")
    _check_final(world, "sorted3d", ref, 1e-4)


def test_sharded_sorted_es_pallas_2d_matches_reference(world):
    """backend='pallas' in 2D: the port's plain B1 on each shard's
    pseudo-grid against the reference's kernel (interpret mode), row for
    row, with the carried rho to 1e-5 of its max."""
    ref = _check_built(world, "pallas2d")
    _check_stepped(world, "pallas2d")
    _check_final(world, "pallas2d", ref, 1e-4)


def test_sharded_sorted_es_pallas_3d_matches_reference(world):
    ref = _check_built(world, "pallas3d")
    _check_stepped(world, "pallas3d")
    _check_final(world, "pallas3d", ref, 1e-4)


def test_sharded_sorted_es_single_shard(world):
    """One shard: the ring is the rank itself (halos and aprons are its
    own opposite slabs), the slab-centred frame keeps every row inside
    the pseudo-grid."""
    ref = _check_built(world, "single")
    _check_stepped(world, "single")
    _check_final(world, "single", ref, 1e-4)
    assert int(_ring(world, "single")[0]["final"]["spill"][0]) < 2000 * 0.02


def test_sharded_sorted_es_single_shard_pallas(world):
    """One shard on the fused composition: the world-of-one path that
    chip_smoke.py drives on the card."""
    ref = _check_built(world, "single_pallas")
    _check_stepped(world, "single_pallas")
    _check_final(world, "single_pallas", ref, 1e-4)


@pytest.mark.parametrize("name", ["repair2d", "repair_pallas2d",
                                  "repair3d"])
def test_sharded_sorted_es_repair_matches_reference(world, name):
    """repair=True with the resort off under sustained drift: spilled rows
    relocate in-shard and arrivals seat straight into their tile, row for
    row with the reference (slots, stacks and counts exactly); nothing is
    lost."""
    ref = _check_built(world, name)
    _check_stepped(world, name)
    _check_final(world, name, ref, 1e-4)
    parts = _ring(world, name)
    assert int(_stack([p["final"] for p in parts], "spill").sum()) > 0
    assert parts[0]["invariants"]["overflow"] == 0
    n = world["cases"][name]["position"].shape[0]
    assert parts[0]["particles"][0].shape[0] == n


def test_sharded_sorted_es_repair_eager_matches_reference(world):
    ref = _check_built(world, "eager2d")
    _check_stepped(world, "eager2d")
    _check_final(world, "eager2d", ref, 1e-4)


def test_sharded_repair_overflow_triggers_resort(world):
    """Tiny stacks under a flood: dropped arrivals are counted exactly as
    the reference counts them, warn, schedule a resort, and live + dropped
    is the population."""
    name = "overflow"
    ref = _check_built(world, name)
    _check_stepped(world, name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _check_final(world, name, ref, 1e-4)
    parts = _ring(world, name)
    dropped = parts[0]["invariants"]["overflow"]
    assert dropped > 0
    assert any("dropped" in w for p in parts for w in p["warnings"])
    assert parts[0]["particles"][0].shape[0] + dropped == 2000


def test_world_of_one_started_by_make_mesh(tmp_path):
    """``make_mesh(1)`` with no process group starts a world of one itself
    (an in-memory store; gloo for ``device='cpu'``), in a process of its
    own; the sorted sharded model on it tracks the port's single-device
    ``ElectrostaticPIC`` over 8 steps across resorts, at the reference
    test's tolerance (2e-3 cells, tests/test_es_sharded.py:283-314)."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    case = dict(_cases()[-2])          # 'single': 2000 particles on 32^2
    assert case["name"] == "single"
    case["position"], case["velocity"] = case.pop("data")
    case_file, out_file = tmp_path / "case.pkl", tmp_path / "out.pkl"
    case_file.write_bytes(pickle.dumps(case))
    code = (
        "import pickle, sys\n"
        "import numpy as np, torch, torch.distributed as dist\n"
        "torch.set_num_threads(1)\n"
        "from fusion_sim_torch.models import electrostatic as es\n"
        "from fusion_sim_torch.models.electrostatic_sharded import "
        "ShardedElectrostaticPIC\n"
        "from fusion_sim_torch.parallel.mesh import make_mesh\n"
        "from torch_ranks import _es_config\n"
        "case = pickle.loads(open(sys.argv[1], 'rb').read())\n"
        "mesh = make_mesh(1, ('space',), device='cpu')\n"
        "assert dist.get_world_size() == 1 and "
        "dist.get_backend() == 'gloo'\n"
        "cfg = _es_config(case)\n"
        "sim = ShardedElectrostaticPIC(cfg, mesh, case['position'], "
        "case['velocity'], device='cpu')\n"
        "ref = es.ElectrostaticPIC(cfg.base, case['position'], "
        "case['velocity'], device='cpu')\n"
        "sim.step(8); ref.step(8)\n"
        "open(sys.argv[2], 'wb').write(pickle.dumps((sim.gather_particles(),"
        " ref.get_state(), sim.check_invariants())))\n")
    tests = Path(__file__).resolve().parent
    path = os.pathsep.join([str(tests.parent), str(tests)]
                           + os.environ.get("PYTHONPATH", "").split(
                               os.pathsep))
    out = subprocess.run([sys.executable, "-c", code, str(case_file),
                          str(out_file)], cwd=tests.parent,
                         env=dict(os.environ, PYTHONPATH=path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (pos, vel), ref, inv = pickle.loads(out_file.read_bytes())
    assert inv["overflow"] == 0 and inv["disp_bound_ok"]
    _match((pos, vel), (ref["position"], ref["velocity"]), 2e-3)
