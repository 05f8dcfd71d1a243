"""Port vs reference: the two-axis sharded ES and EM models (counterparts
of tests/test_es_sharded2d.py and tests/test_em_sharded2d.py), each case
against the reference's same model on a mesh of the same shape.

One gloo world of four ranks runs every case of the file
(``torch_ranks.mesh2d_body``) on the (2, 2), (4, 1) and (1, 4) meshes of
the world, and on (1, 1) meshes of single ranks (each rank its own case,
at once).  The reference uses (2, 4), which needs eight ranks: (4, 1) and
(1, 4) give an axis a ring with distinct left and right neighbours, (2,
2) the two-hop corners and diagonal crossers on both axes.  The reference
runs in this process on meshes of the same shapes over its fake CPU
devices while the world runs (``torch_ranks.run_world_beside``), one
compiled step at a time.

How each case compares:
* the plain EM composition, from the same positions: row for row, counts
  exactly, positions within 2e-5 cells, velocities within 1e-6, E and B
  within 1e-5 of their max; and against the port's single-device model
  at the reference test's tolerances;
* the plain ES composition: the live particles as a set matched to the
  nearest row within 1e-4 (the dense-DFT and pencil solves of the two
  packages differ at f32 rounding; 1e-3 after 30 steps), the overflow
  exactly; and against the port's single-device model within 2e-3, the
  reference test's tolerance;
* the sorted compositions: the constructor's layout per tile segment as
  sets; ``steps`` steps from the reference's own state (``from_state``)
  row for row at the tolerances above (the carried rho within 1e-5 of its
  max); then ``more`` shell steps with resorts, the live particles as a
  set within 1e-4 and the overflow exactly.
"""

import numpy as np
import pytest

from torch_ranks import (check_layout, check_rows, match_rows, mesh2d_body,
                         run_world_beside, stack, stack_blocks)

TWO_PI = 2 * np.pi
TILING_2D = dict(tile_r=8, tile_z=8, block=128, margin=2)
TILING_3D = dict(tile=(4, 4, 4), block=128, margin=1)
ATOL, FIELD_TOL = 2e-5, 1e-5


def _es_base(shape, n):
    vol = TWO_PI ** len(shape)
    return dict(grid_shape=shape,
                cell_size=tuple(TWO_PI / s for s in shape[:2])
                + tuple(TWO_PI / s for s in shape[2:]),
                dt=0.05, charge=-vol / n, mass=vol / n)


def _em_base(shape, dt=0.2):
    return dict(grid_shape=shape, cell_size=(0.5,) * len(shape),
                dt=dt * 0.5, charge=-0.01, mass=0.01,
                field_gather="centered")


def _particles(n, shape, seed, vdim, vscale):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, len(shape))) * np.array(shape)).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, vdim))).astype(np.float32)
    return pos, vel


def _diagonal(n, shape, cells_per_step, config, vdim, seed=0):
    """Every particle drifting diagonally at ``cells_per_step``."""
    pos, _ = _particles(n, shape, seed, vdim, 0.0)
    vel = np.zeros((n, vdim), np.float32)
    vel[:, :2] = cells_per_step * config["cell_size"][0] / config["dt"]
    return pos, vel


def _cases():
    """Every case: its model kind, mesh (and ranks for (1, 1)),
    configuration, particles and steps."""
    sq64, sq32 = (64, 64), (32, 32)
    es64 = _es_base(sq64, 4000)
    em64 = _em_base(sq64)
    es_diag_base = _es_base(sq64, 2000)
    em_diag_base = _em_base(sq64)
    box3 = (16, 16, 8)
    return [
        # tests/test_es_sharded2d.py:46-63 (gathered DFT), on (2, 2)
        dict(name="es_plain", kind="es2d", mesh=(2, 2), config=dict(
            base=es64, mesh_shape=(2, 2), capacity=1536,
            migration_buffer=128),
            data=_particles(4000, sq64, 0, 2, 0.05), steps=6),
        # :66-84, the pencil route forced on a 2D grid, on (4, 1)
        dict(name="es_pencil", kind="es2d", mesh=(4, 1), dft_max=16,
             config=dict(base=es64, mesh_shape=(4, 1), capacity=1536,
                         migration_buffer=128),
             data=_particles(4000, sq64, 0, 2, 0.05), steps=4),
        # :87-113, 3D (pencil) on (2, 2)
        dict(name="es_3d", kind="es2d", mesh=(2, 2), config=dict(
            base=_es_base(box3, 3000), mesh_shape=(2, 2), capacity=1024,
            migration_buffer=128),
            data=_particles(3000, box3, 3, 3, 0.05), steps=4),
        # :116-137, a diagonal drift crossing both block boundaries
        dict(name="es_diag", kind="es2d", mesh=(2, 2), config=dict(
            base=es_diag_base, mesh_shape=(2, 2), capacity=2048,
            migration_buffer=1024),
            data=_diagonal(2000, sq64, 0.8, es_diag_base, 2), steps=30),
        # debug_checks raising (tests/test_em_sharded2d.py:124-133's case
        # for the ES model), on (1, 4)
        dict(name="es_debug", kind="es2d", mesh=(1, 4), config=dict(
            base=_es_base(sq64, 500), mesh_shape=(1, 4), capacity=512,
            migration_buffer=256, debug_checks=True),
            data=_diagonal(500, sq64, 40.0, _es_base(sq64, 500), 2, 7),
            steps=1, expect_raise=True),
        # :140-168, the sorted composition (xla), on (1, 4)
        dict(name="es_sorted", kind="es2d", mesh=(1, 4), from_state=True,
             config=dict(base=es64, mesh_shape=(1, 4), capacity=1536,
                         migration_buffer=64, tiling=TILING_2D,
                         resort_every=4),
             data=_particles(4000, sq64, 0, 2, 0.05), steps=3, more=5),
        # :171-203, backend 'pallas' (B1's plain version here, the
        # reference's kernel in interpret mode), on (2, 2)
        dict(name="es_pallas", kind="es2d", mesh=(2, 2), from_state=True,
             config=dict(base=_es_base(sq32, 2048), mesh_shape=(2, 2),
                         capacity=1024, migration_buffer=64,
                         tiling=TILING_2D, resort_every=2,
                         backend="pallas"),
             data=_particles(2048, sq32, 4, 2, 0.1), steps=2, more=3),
        # tests/test_em_sharded2d.py:47-58, the plain EM composition
        dict(name="em_plain", kind="em2d", mesh=(2, 2), config=dict(
            base=em64, mesh_shape=(2, 2), capacity=1024,
            migration_buffer=64),
            data=_particles(2000, sq64, 0, 3, 0.2), steps=10),
        # :61-82, 3D on (4, 1)
        dict(name="em_plain3d", kind="em2d", mesh=(4, 1), config=dict(
            base=_em_base(box3, 0.15), mesh_shape=(4, 1), capacity=1024,
            migration_buffer=64),
            data=_particles(1500, box3, 2, 3, 0.2), steps=6),
        # :85-103, the diagonal drift on (2, 2)
        dict(name="em_diag", kind="em2d", mesh=(2, 2), config=dict(
            base=em_diag_base, mesh_shape=(2, 2), capacity=2048,
            migration_buffer=1024),
            data=_diagonal(1500, sq64, 0.8, em_diag_base, 3), steps=25),
        # :106-115, debug_checks
        dict(name="em_debug", kind="em2d", mesh=(2, 2), config=dict(
            base=_em_base(sq64), mesh_shape=(2, 2), capacity=512,
            migration_buffer=256, debug_checks=True),
            data=_diagonal(500, sq64, 12.0, _em_base(sq64), 3, 7), steps=1,
            expect_raise=True),
        # :118-152, the sorted EM composition (xla), on (1, 4)
        dict(name="em_sorted", kind="em2d", mesh=(1, 4), from_state=True,
             config=dict(base=em64, mesh_shape=(1, 4), capacity=1024,
                         migration_buffer=64, tiling=TILING_2D,
                         resort_every=4),
             data=_particles(2000, sq64, 0, 3, 0.2), steps=3, more=5),
        # :155-180, gather_backend 'fused' (B4) on (2, 2)
        dict(name="em_fused", kind="em2d", mesh=(2, 2), from_state=True,
             config=dict(base=_em_base(sq32), mesh_shape=(2, 2),
                         capacity=512, migration_buffer=64,
                         tiling=TILING_2D, resort_every=2,
                         gather_backend="fused"),
             data=_particles(1024, sq32, 0, 3, 0.2), steps=2, more=3),
        # 'fused' in 3D (B6) on (1, 4)
        dict(name="em_fused3d", kind="em2d", mesh=(1, 4), from_state=True,
             config=dict(base=_em_base(box3, 0.15), mesh_shape=(1, 4),
                         capacity=512, migration_buffer=64,
                         tiling=TILING_3D, resort_every=2,
                         gather_backend="fused"),
             data=_particles(1024, box3, 9, 3, 0.2), steps=2, more=3),
        # :200-206, a mesh of the wrong shape is refused
        dict(name="bad_mesh", kind="es2d", mesh=(2, 2), bad_mesh=True,
             config=dict(base=es64, mesh_shape=(4, 1), capacity=1024,
                         migration_buffer=128),
             data=_particles(4000, sq64, 0, 2, 0.05), steps=0),
        # (1, 1) meshes, one a rank, at once: 'pallas' in 3D (B5), the
        # sorted EM (xla), the sorted ES (xla) in 3D, the plain EM in 3D
        dict(name="single_es_pallas3d", kind="es2d", mesh=(1, 1),
             ranks=(0,), from_state=True, config=dict(
                 base=_es_base((16, 16, 16), 1024), mesh_shape=(1, 1),
                 capacity=1024, migration_buffer=64, tiling=TILING_3D,
                 resort_every=2, backend="pallas"),
             data=_particles(1024, (16, 16, 16), 6, 3, 0.1), steps=2,
             more=3),
        dict(name="single_em_sorted", kind="em2d", mesh=(1, 1), ranks=(1,),
             from_state=True, config=dict(
                 base=_em_base(sq32), mesh_shape=(1, 1), capacity=2048,
                 migration_buffer=64, tiling=TILING_2D, resort_every=4),
             data=_particles(2000, sq32, 1, 3, 0.2), steps=3, more=5),
        dict(name="single_es_sorted3d", kind="es2d", mesh=(1, 1),
             ranks=(2,), from_state=True, config=dict(
                 base=_es_base((16, 16, 16), 1024), mesh_shape=(1, 1),
                 capacity=1024, migration_buffer=64, tiling=TILING_3D,
                 resort_every=3),
             data=_particles(1024, (16, 16, 16), 2, 3, 0.1), steps=2,
             more=4),
        dict(name="single_em_plain3d", kind="em2d", mesh=(1, 1), ranks=(3,),
             config=dict(base=_em_base(box3, 0.15), mesh_shape=(1, 1),
                         capacity=2048, migration_buffer=64),
             data=_particles(1500, box3, 2, 3, 0.2), steps=6),
    ]


def _jax_model(kind):
    if kind == "es2d":
        from fusion_sim_tpu.models import electrostatic as base
        from fusion_sim_tpu.models import electrostatic_sharded2d as sh
        return (base.ESConfig, sh.ShardedESConfig2D,
                sh.ShardedElectrostaticPIC2D)
    from fusion_sim_tpu.models import electromagnetic as base
    from fusion_sim_tpu.models import electromagnetic_sharded2d as sh
    return (base.EMConfig, sh.ShardedEMConfig2D,
            sh.ShardedElectromagneticPIC2D)


def _jax_sim(case):
    from fusion_sim_tpu.ops.sorted_deposit import Tiling2D, Tiling3D
    from fusion_sim_tpu.parallel.mesh import make_mesh

    base_cls, cfg_cls, cls = _jax_model(case["kind"])
    kw = dict(case["config"])
    base = base_cls(**kw.pop("base"))
    tiling = kw.pop("tiling", None)
    if tiling is not None:
        tiling = (Tiling2D(**tiling) if "tile_r" in tiling
                  else Tiling3D(**tiling))
    shape = case["mesh"]
    mesh = make_mesh(shape[0] * shape[1], ("sx", "sy"), shape=shape)
    return cls(cfg_cls(base=base, tiling=tiling, **kw), mesh,
               case["position"], case["velocity"])


def _state(sim):
    return {k: np.asarray(v) for k, v in sim.state._asdict().items()
            if v is not None}


def _dft_max(value):
    """The reference's GATHERED_DFT_MAX set to ``value`` (the switch its
    own pencil test patches) for the duration of a ``with``."""
    from fusion_sim_tpu.models import electrostatic_sharded as es1d

    mp = pytest.MonkeyPatch()
    if value is not None:
        mp.setattr(es1d, "GATHERED_DFT_MAX", value)
    return mp


def _reference_run(case):
    """The reference's side of a case, as the ranks run theirs (the
    constructor's state is captured before: ``initial``)."""
    res = {}
    if case.get("bad_mesh"):
        try:
            _jax_sim(case)
            res["raised"] = None
        except ValueError as exc:
            res["raised"] = str(exc)
        return res
    sim = case.pop("_sim")
    mp = _dft_max(case.get("dft_max"))
    try:
        if case.get("expect_raise"):
            try:
                sim.step(case["steps"])
                res["raised"] = None
            except RuntimeError as exc:
                res["raised"] = str(exc)
            return res
        for _ in range(case["steps"]):   # one compiled step at a time
            sim.state = sim._step(sim.state)
        if sim.sorted:
            sim._since_sort = case["steps"]   # the cadence goes on
        res["stepped"] = _state(sim)
        if getattr(sim.config, "backend", None) == "pallas":
            res["seed_rho"] = np.asarray(sim._seed_rho(sim.state))
        for _ in range(case.get("more", 0)):
            sim.step(1)
        res["final"] = _state(sim)
        res["particles"] = sim.gather_particles()
        res["invariants"] = sim.check_invariants()
    finally:
        mp.undo()
    return res


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = []
    for case in _cases():
        case = dict(case)
        case["position"], case["velocity"] = case.pop("data")
        if not case.get("bad_mesh"):
            mp = _dft_max(case.get("dft_max"))
            try:
                case["_sim"] = sim = _jax_sim(case)
            finally:
                mp.undo()
            if case.pop("from_state", False):
                case["initial"] = _state(sim)
        cases.append(case)
    sent = [{k: v for k, v in c.items() if k != "_sim"} for c in cases]
    ranks, refs = run_world_beside(
        4, mesh2d_body, {"cases": sent}, tmp_path_factory.mktemp("sharded2d"),
        lambda: {c["name"]: _reference_run(c) for c in cases})
    return {"ranks": ranks, "cases": {c["name"]: c for c in sent},
            "refs": refs}


def _mesh_parts(world, name):
    """The results of one case, in mesh order (ix * Sy + iy; the world's
    ranks are laid out so)."""
    case = world["cases"][name]
    ranks = case.get("ranks") or range(4)
    return [world["ranks"][r][name] for r in ranks]


def _global(parts, stage, mesh_shape):
    out = {}
    for k in parts[0][stage]:
        if k in ("e", "b", "rho"):
            out[k] = stack_blocks([p[stage] for p in parts], k, mesh_shape)
        else:
            out[k] = stack([p[stage] for p in parts], k)
    return out


def _check_final(world, name, atol):
    """The live particles as a set (the same on every rank), the overflow
    per shard and the invariants."""
    case, ref = world["cases"][name], world["refs"][name]
    parts = _mesh_parts(world, name)
    got = parts[0]["particles"]
    for p in parts[1:]:
        for a, b in zip(p["particles"], got):
            np.testing.assert_array_equal(a, b)
    match_rows(got, ref["particles"], atol)
    final = _global(parts, "final", case["mesh"])
    np.testing.assert_array_equal(final["overflow"],
                                  ref["final"]["overflow"])
    inv = ref["invariants"]
    for p in parts:
        assert p["invariants"]["overflow"] == inv["overflow"]
        assert p["invariants"]["disp_bound_ok"] == inv["disp_bound_ok"]
        np.testing.assert_allclose(p["invariants"]["max_disp_cells"],
                                   inv["max_disp_cells"], rtol=1e-5)
    return parts, final


def _check_rows_case(world, name):
    """The built layouts (sorted), the stepped state row for row, the
    final particles as a set, fields within 1e-4 of their max."""
    case, ref = world["cases"][name], world["refs"][name]
    parts = _mesh_parts(world, name)
    if "initial" in case:
        init = case["initial"]
        rows = init["position"].shape[0] // len(parts)
        for s, part in enumerate(parts):
            check_layout(part["built"], {
                k: init[k][s * rows:(s + 1) * rows]
                for k in ("tile_id", "alive", "position", "velocity")})
    stepped = _global(parts, "stepped", case["mesh"])
    check_rows(stepped, ref["stepped"], ATOL, FIELD_TOL)
    if "seed_rho" in ref:
        # the carried rho is the deposit at the current positions
        seed = stack_blocks(parts, "seed_rho", case["mesh"])
        scale = np.abs(ref["seed_rho"]).max()
        np.testing.assert_allclose(seed, ref["seed_rho"], rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(stepped["rho"], seed, rtol=0,
                                   atol=1e-5 * scale)
    parts, final = _check_final(world, name, 1e-4)
    for key in ("e", "b"):
        if key in final:
            scale = np.abs(ref["final"][key]).max()
            np.testing.assert_allclose(final[key], ref["final"][key],
                                       rtol=0, atol=1e-4 * scale)
    assert final["overflow"].sum() == 0
    return parts, final


def _single_device(world, name):
    """The port's single-device model over the case's steps."""
    from fusion_sim_torch.models import electromagnetic as tem
    from fusion_sim_torch.models import electrostatic as tes

    case = world["cases"][name]
    if case["kind"] == "es2d":
        sim = tes.ElectrostaticPIC(tes.ESConfig(**case["config"]["base"]),
                                   case["position"], case["velocity"],
                                   device="cpu")
    else:
        sim = tem.ElectromagneticPIC(tem.EMConfig(**case["config"]["base"]),
                                     case["position"], case["velocity"],
                                     device="cpu")
    sim.step(case["steps"])
    return sim.get_state()


@pytest.mark.parametrize("name", ["es_plain", "es_pencil", "es_3d"])
def test_sharded2d_es_matches_reference_and_single_device(world, name):
    """The plain ES composition on (2, 2) (gathered dense DFT), on (4, 1)
    with the pencil route forced (GATHERED_DFT_MAX patched down, as the
    reference's test does) and in 3D on (2, 2) (pencil): the reference's
    particles to 1e-4, and the port's single-device model's as sorted
    columns within 2e-3 (tests/test_es_sharded2d.py's tolerance)."""
    parts, final = _check_final(world, name, 1e-4)
    inv = parts[0]["invariants"]
    assert inv["overflow"] == 0 and inv["disp_bound_ok"]
    pos, vel = parts[0]["particles"]
    single = _single_device(world, name)
    assert pos.shape == single["position"].shape
    for ax in range(pos.shape[1]):
        np.testing.assert_allclose(np.sort(pos[:, ax]),
                                   np.sort(single["position"][:, ax]),
                                   atol=2e-3)
        np.testing.assert_allclose(np.sort(vel[:, ax]),
                                   np.sort(single["velocity"][:, ax]),
                                   atol=2e-3)


@pytest.mark.parametrize("name", ["es_diag", "em_diag"])
def test_sharded2d_diagonal_migration_conserves(world, name):
    """A uniform diagonal drift (0.8 cells a step) crosses both block
    boundaries of the (2, 2) mesh, corner crossers in two phases: nothing
    overflows, the population is conserved, and the particles match the
    reference's (1e-3 after 25-30 steps); the EM run row for row."""
    case = world["cases"][name]
    if case["kind"] == "em2d":
        _check_rows_case(world, name)
    parts, final = _check_final(world, name, 1e-3)
    assert parts[0]["invariants"]["overflow"] == 0
    assert parts[0]["particles"][0].shape[0] == case["position"].shape[0]
    assert int(final["alive"].sum()) == case["position"].shape[0]


@pytest.mark.parametrize("name", ["es_debug", "em_debug"])
def test_sharded2d_debug_checks_raises_on_fast_particles(world, name):
    assert "migration invariant violated" in world["refs"][name]["raised"]
    for part in _mesh_parts(world, name):
        assert "migration invariant violated" in part["raised"]


@pytest.mark.parametrize("name", ["em_plain", "em_plain3d",
                                  "single_em_plain3d"])
def test_sharded2d_em_matches_reference_and_single_device(world, name):
    """The plain EM composition on (2, 2), in 3D on (4, 1) and on a (1, 1)
    mesh: row for row with the reference, every row in its block after
    each step, and against the port's single-device model
    (tests/test_em_sharded2d.py's tolerances: fields rtol 2e-4, atol
    2e-5; positions 1e-4)."""
    parts, final = _check_rows_case(world, name)
    for part in parts:
        assert all(part["owned"])
    single = _single_device(world, name)
    for key in ("e", "b"):
        np.testing.assert_allclose(final[key], single[key], rtol=2e-4,
                                   atol=2e-5, err_msg=key)
    pos, _ = parts[0]["particles"]
    ref_pos = single["position"]
    order_a = np.lexsort(pos[:, ::-1].T)
    order_b = np.lexsort(ref_pos[:, ::-1].T)
    np.testing.assert_allclose(pos[order_a], ref_pos[order_b], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["es_sorted", "em_sorted",
                                  "single_em_sorted", "single_es_sorted3d"])
def test_sharded2d_sorted_xla_matches_reference(world, name):
    _check_rows_case(world, name)


@pytest.mark.parametrize("name", ["es_pallas", "em_fused", "em_fused3d",
                                  "single_es_pallas3d"])
def test_sharded2d_fused_matches_reference(world, name):
    """backend='pallas' / gather_backend='fused': the port's plain B1, B4,
    B6 and B5 on each shard's two-axis pseudo-grid (windows wrapping onto
    y halo cells) against the reference's kernels in interpret mode, row
    for row, with the carried rho (ES) within 1e-5 of its max."""
    _check_rows_case(world, name)


def test_sharded2d_rejects_bad_mesh_shape(world):
    """A (2, 2) mesh with a config for (4, 1) is refused, as the reference
    refuses it."""
    assert "mesh shape" in world["refs"]["bad_mesh"]["raised"]
    for part in _mesh_parts(world, "bad_mesh"):
        assert "mesh shape" in part["raised"]
