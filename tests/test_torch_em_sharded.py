"""Port vs reference: the sharded EM model (counterparts of
tests/test_em_sharded.py), each case against the reference's same model
at the same number of shards.

One gloo world of four ranks runs every case of the file
(``torch_ranks.em_body``): rings of four, rings of two (ranks (0, 1) and
(2, 3) run different cases at once) and single shards.  The reference
runs in this process on meshes of the same sizes over its fake CPU
devices, while the world runs (``torch_ranks.run_world_beside``), one
compiled step at a time.

How each case compares:
* the plain composition, from the same positions: row for row (both
  packages bucket the particles alike and migrate with stable sorts),
  counts exactly, positions within 2e-5 cells, velocities within 1e-6,
  E and B within 1e-5 of their max (the deposits' f32 sums run in
  another order); and against the port's single-device model at the
  reference test's tolerances;
* the sorted compositions: the constructor's layout per tile segment as
  sets (``torch.sort`` is stable, the reference's ``lax.sort`` is not,
  and the fused 2D layout orders rows by cell as the single-device fused
  shell does); then ``steps`` steps from the reference's own state
  (``from_state``) row for row, at the same tolerances; then ``more``
  shell steps, the cadence counting on from those steps (resorts
  included), the live particles as a set matched to
  the nearest row within 1e-4, the overflow per shard exactly.
"""

import numpy as np
import pytest

from torch_ranks import (check_layout, check_rows, em_body, match_rows,
                         run_world_beside, stack)

D = 0.5
TILING_2D = dict(tile_r=8, tile_z=8, block=128, margin=2)
TILING_3D = dict(tile=(4, 4, 4), block=128, margin=1)
ATOL, FIELD_TOL = 2e-5, 1e-5


def _base(n_cells, ndim=2, dt=0.2):
    return dict(grid_shape=(n_cells,) * ndim, cell_size=(D,) * ndim,
                dt=dt * D, charge=-0.01, mass=0.01, field_gather="centered")


def _particles(n, n_cells, ndim, seed, vscale=0.2, drift=0.0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, ndim)) * n_cells).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    vel[:, 0] += drift
    return pos, vel


def _cases():
    """Every case: its ring (``mesh``: 4, 2 or 1 shards, on ``ranks``),
    configuration, particles and steps."""
    ring4 = dict(mesh=4, n_shards=4)
    sorted2d = dict(base=_base(64), n_shards=4, capacity=1024,
                    migration_buffer=64, tiling=TILING_2D, resort_every=4)
    return [
        # tests/test_em_sharded.py:31-57, the plain composition (2D)
        dict(ring4, name="plain2d", config=dict(
            base=_base(64), n_shards=4, capacity=1024, migration_buffer=64),
            data=_particles(2000, 64, 2, 0), steps=10),
        # :136-167, 3D on a ring of two
        dict(name="plain3d", mesh=2, n_shards=2, ranks=(0, 1), config=dict(
            base=_base(16, 3, 0.15), n_shards=2, capacity=1024,
            migration_buffer=128),
            data=_particles(1000, 16, 3, 5), steps=6),
        # :350-382 / 403-433, 3D sorted + 3D repair on the other ring of two
        dict(name="sorted3d", mesh=2, n_shards=2, ranks=(2, 3),
             from_state=True, config=dict(
                 base=_base(16, 3, 0.15), n_shards=2, capacity=1024,
                 migration_buffer=64, tiling=TILING_3D, resort_every=3),
             data=_particles(1024, 16, 3, 9), steps=2, more=4),
        # :60-74, debug_checks raising on fast particles
        dict(ring4, name="debug", config=dict(
            base=_base(64), n_shards=4, capacity=512, migration_buffer=256,
            debug_checks=True),
            data=_particles(500, 64, 2, 7, drift=30.0), steps=1,
            expect_raise=True),
        # :77-91, particles stay owned
        dict(ring4, name="owned", config=dict(
            base=_base(64), n_shards=4, capacity=1024, migration_buffer=64),
            data=_particles(2000, 64, 2, 1), steps=5),
        # :170-179, Gauss and energy sanity over 20 steps
        dict(ring4, name="gauss", config=dict(
            base=_base(64), n_shards=4, capacity=1024, migration_buffer=64),
            data=_particles(2000, 64, 2, 2), steps=20),
        # :182-213, the sorted composition (xla) in 2D
        dict(ring4, name="sorted2d", from_state=True, config=sorted2d,
             data=_particles(2000, 64, 2, 0), steps=3, more=5),
        # :216-250, gather_backend 'fused' in 2D (B4's plain version here,
        # the reference's kernel in interpret mode)
        dict(ring4, name="fused2d", from_state=True, config=dict(
            base=_base(32), n_shards=4, capacity=512, migration_buffer=64,
            tiling=TILING_2D, resort_every=2, gather_backend="fused"),
            data=_particles(1024, 32, 2, 0), steps=2, more=3),
        # :253-282, 'fused' in 3D (B6) on a ring of two
        dict(name="fused3d", mesh=2, n_shards=2, ranks=(0, 1),
             from_state=True, config=dict(
                 base=_base(16, 3, 0.15), n_shards=2, capacity=1024,
                 migration_buffer=64, tiling=TILING_3D, resort_every=2,
                 gather_backend="fused"),
             data=_particles(1024, 16, 3, 9), steps=2, more=3),
        dict(name="repair3d", mesh=2, n_shards=2, ranks=(2, 3),
             from_state=True, config=dict(
                 base=_base(16, 3, 0.15), n_shards=2, capacity=1024,
                 migration_buffer=128, tiling=TILING_3D,
                 resort_every=10 ** 6, repair=True),
             data=_particles(1024, 16, 3, 5, drift=1.2), steps=4, more=2),
        # :343-384, repair with the resort off under sustained drift
        dict(ring4, name="repair_xla", from_state=True, config=dict(
            sorted2d, migration_buffer=128, resort_every=10 ** 6,
            repair=True),
            data=_particles(2000, 64, 2, 0, drift=1.2), steps=4, more=2),
        dict(ring4, name="repair_fused", from_state=True, config=dict(
            sorted2d, migration_buffer=128, resort_every=10 ** 6,
            repair=True, gather_backend="fused"),
            data=_particles(2048, 64, 2, 3, drift=1.2), steps=3, more=1),
        # :436-470, eager repair
        dict(ring4, name="eager", from_state=True, config=dict(
            sorted2d, capacity=2048, resort_every=10 ** 6, repair=True,
            repair_eager=1),
            data=_particles(4096, 64, 2, 2, vscale=0.1, drift=2.0),
            steps=3, more=2),
        # :285-309, one shard (its ring is the rank itself)
        dict(name="single", mesh=1, n_shards=1, ranks=(0,),
             from_state=True, config=dict(
                 sorted2d, n_shards=1, capacity=2048),
             data=_particles(2000, 64, 2, 0), steps=3, more=5),
    ]


def _jax_sim(case):
    from fusion_sim_tpu.models import electromagnetic as jem
    from fusion_sim_tpu.models.electromagnetic_sharded import (
        ShardedEMConfig, ShardedElectromagneticPIC)
    from fusion_sim_tpu.ops.sorted_deposit import Tiling2D, Tiling3D
    from fusion_sim_tpu.parallel.mesh import make_mesh

    kw = dict(case["config"])
    base = jem.EMConfig(**kw.pop("base"))
    tiling = kw.pop("tiling", None)
    if tiling is not None:
        tiling = (Tiling2D(**tiling) if "tile_r" in tiling
                  else Tiling3D(**tiling))
    return ShardedElectromagneticPIC(
        ShardedEMConfig(base=base, tiling=tiling, **kw),
        make_mesh(case["n_shards"], ("space",)), case["position"],
        case["velocity"])


def _state(sim):
    return {k: np.asarray(v) for k, v in sim.state._asdict().items()
            if v is not None}


def _reference_run(case, sim):
    """The reference's side of a case, as the ranks run theirs."""
    res = {}
    if case.get("expect_raise"):
        try:
            sim.step(case["steps"])
            res["raised"] = None
        except RuntimeError as exc:
            res["raised"] = str(exc)
        return res
    repair = case["config"].get("repair")
    for _ in range(case["steps"]):   # one compiled step at a time
        if repair:
            sim.step(1)
        else:
            sim.state = sim._step(sim.state)
    if sim.sorted and not repair:
        sim._since_sort = case["steps"]   # the shell's cadence goes on
    res["stepped"] = _state(sim)
    for _ in range(case.get("more", 0)):
        sim.step(1)
    res["final"] = _state(sim)
    res["particles"] = sim.gather_particles()
    res["invariants"] = sim.check_invariants()
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, sims = [], {}
    for case in _cases():
        case = dict(case)
        case["position"], case["velocity"] = case.pop("data")
        sims[case["name"]] = sim = _jax_sim(case)
        if case.pop("from_state", False):
            case["initial"] = _state(sim)
        cases.append(case)
    ranks, refs = run_world_beside(
        4, em_body, {"cases": cases}, tmp_path_factory.mktemp("em_sharded"),
        lambda: {c["name"]: _reference_run(c, sims[c["name"]])
                 for c in cases})
    return {"ranks": ranks, "cases": {c["name"]: c for c in cases},
            "refs": refs}


def _ring(world, name):
    """The results of one case, in shard order."""
    case = world["cases"][name]
    ranks = case.get("ranks") or range(case["n_shards"])
    return [world["ranks"][r][name] for r in ranks]


def _global(parts, stage):
    return {k: stack([p[stage] for p in parts], k)
            for k in parts[0][stage]}


def _check_case(world, name, final_atol=1e-4):
    """The built layouts (sorted), the stepped state row for row, the
    final particles as a set with the overflow and fields."""
    case, ref = world["cases"][name], world["refs"][name]
    parts = _ring(world, name)
    if "initial" in case:
        init = case["initial"]
        rows = init["position"].shape[0] // case["n_shards"]
        for s, part in enumerate(parts):
            check_layout(part["built"], {
                k: init[k][s * rows:(s + 1) * rows]
                for k in ("tile_id", "alive", "position", "velocity")})
    check_rows(_global(parts, "stepped"), ref["stepped"], ATOL, FIELD_TOL)
    got = parts[0]["particles"]
    for p in parts[1:]:            # every rank gathers the same particles
        for a, b in zip(p["particles"], got):
            np.testing.assert_array_equal(a, b)
    match_rows(got, ref["particles"], final_atol)
    final = _global(parts, "final")
    np.testing.assert_array_equal(final["overflow"],
                                  ref["final"]["overflow"])
    for key in ("e", "b"):
        scale = np.abs(ref["final"][key]).max()
        np.testing.assert_allclose(final[key], ref["final"][key], rtol=0,
                                   atol=1e-4 * scale, err_msg=key)
    inv = ref["invariants"]
    for p in parts:
        assert p["invariants"]["overflow"] == inv["overflow"]
        assert p["invariants"]["disp_bound_ok"] == inv["disp_bound_ok"]
        np.testing.assert_allclose(p["invariants"]["max_disp_cells"],
                                   inv["max_disp_cells"], rtol=1e-5)
    return parts, final


def _single_device(name, world):
    """The port's single-device model over the case's steps."""
    from fusion_sim_torch.models import electromagnetic as tem

    case = world["cases"][name]
    sim = tem.ElectromagneticPIC(tem.EMConfig(**case["config"]["base"]),
                                 case["position"], case["velocity"],
                                 device="cpu")
    sim.step(case["steps"])
    return sim.get_state()


@pytest.mark.parametrize("name", ["plain2d", "plain3d"])
def test_sharded_em_plain_matches_reference_and_single_device(world, name):
    """The plain composition on a ring of four (2D) and of two (3D): row
    for row with the reference's sharded model, and against the port's
    single-device model at tests/test_em_sharded.py's tolerances (fields
    rtol 2e-4, atol 2e-5; positions 1e-4)."""
    parts, final = _check_case(world, name)
    assert final["overflow"].sum() == 0
    single = _single_device(name, world)
    for key in ("e", "b"):
        np.testing.assert_allclose(final[key], single[key], rtol=2e-4,
                                   atol=2e-5, err_msg=key)
    pos, _ = parts[0]["particles"]
    assert pos.shape[0] == world["cases"][name]["position"].shape[0]
    ref_pos = single["position"]
    d2 = ((pos[:, None, :] - ref_pos[None, :, :]) ** 2).sum(-1)
    idx = d2.argmin(axis=1)
    assert len(np.unique(idx)) == len(idx)
    np.testing.assert_allclose(pos, ref_pos[idx], rtol=1e-4, atol=1e-4)


def test_sharded_em_debug_checks_raises_on_fast_particles(world):
    """``debug_checks`` turns a displacement past ``disp_bound`` into a
    RuntimeError on every rank, as the reference's shell raises."""
    assert "migration invariant violated" in world["refs"]["debug"]["raised"]
    for part in _ring(world, "debug"):
        assert "migration invariant violated" in part["raised"]


def test_sharded_em_particles_stay_owned(world):
    """After each of 5 steps every live particle lies in its owner's
    slab, and the run matches the reference row for row."""
    parts, _ = _check_case(world, "owned")
    for part in parts:
        assert part["owned"] == [True] * 5


def test_sharded_em_gauss_and_energy_sanity(world):
    """20 steps: finite fields, no particle lost, and Gauss's law kept
    (Esirkepov conserves charge, so div E - rho holds its initial value
    to 1e-4 of max|rho|)."""
    import torch

    from fusion_sim_torch.models import electromagnetic as tem

    parts, final = _check_case(world, "gauss", final_atol=1e-4)
    case = world["cases"]["gauss"]
    assert np.isfinite(final["e"]).all() and np.isfinite(final["b"]).all()
    pos, _ = parts[0]["particles"]
    assert pos.shape[0] == case["position"].shape[0]
    config = tem.EMConfig(**case["config"]["base"])
    rho0 = tem.charge_density(config, torch.tensor(case["position"]))
    rho1 = tem.charge_density(config, torch.tensor(pos))
    div = tem.yee_divergence(config, torch.tensor(final["e"]))
    drift = (div - rho1 / config.eps0) + rho0 / config.eps0
    assert float(drift.abs().max()) < 1e-4 * float(rho0.abs().max())


@pytest.mark.parametrize("name", ["sorted2d", "sorted3d"])
def test_sharded_sorted_em_xla_matches_reference(world, name):
    parts, final = _check_case(world, name)
    assert final["overflow"].sum() == 0


@pytest.mark.parametrize("name", ["fused2d", "fused3d"])
def test_sharded_sorted_em_fused_matches_reference(world, name):
    """gather_backend='fused': the port's plain B4 (2D) / B6 (3D) on each
    shard's pseudo-grid against the reference's kernel in interpret mode,
    with the exact re-push of out-of-window and trailing-block rows."""
    parts, final = _check_case(world, name)
    assert final["overflow"].sum() == 0


def test_sharded_sorted_em_single_shard(world):
    """One shard: the ring is the rank itself, and the slab-centred frame
    keeps every row inside the pseudo-grid (spill under 1% of rows over 8
    steps, as the reference's test requires on the same particles, and
    equal to the reference's count)."""
    parts, final = _check_case(world, "single")
    assert final["overflow"].sum() == 0
    np.testing.assert_array_equal(final["spill"],
                                  world["refs"]["single"]["final"]["spill"])
    assert int(final["spill"].sum()) < 2000 * 0.01


@pytest.mark.parametrize("name", ["repair_xla", "repair_fused", "repair3d",
                                  "eager"])
def test_sharded_sorted_em_repair_matches_reference(world, name):
    """repair=True with the resort off under sustained drift (eager
    relocation in 'eager'): spilled rows relocate in-shard and arrivals
    seat straight into their tile, row for row with the reference (slots,
    stacks and counts exactly); nothing is lost."""
    parts, final = _check_case(world, name)
    assert final["overflow"].sum() == 0
    n = world["cases"][name]["position"].shape[0]
    assert parts[0]["particles"][0].shape[0] == n
