"""Port vs reference: ``parallel/`` on ``torch.distributed`` (counterparts
of tests/test_parallel.py's ten cases).

One gloo world of four ranks runs every check of the file
(``torch_ranks.parallel_body``): the rings of four and of two (ranks (0,
1) and (2, 3)), the data-parallel pusher, the EM placement and the 2 x 2
mesh.  The reference runs in this process on meshes of the same sizes
over its fake CPU devices (tests/conftest.py), and the ranks' numpy
results are compared here.  Halos, folds and migrations are data
movement: they must agree exactly.  The stepped particles agree to f32
rounding (tolerances at each comparison)."""

import numpy as np
import pytest

from torch_ranks import (grid_migration_inputs, parallel_body,
                         ring_migration_inputs, run_world)

SPEC = {"radius": 1.0, "height": 2.0, "nr": 32, "nz": 64, "dt": 2e-9,
        "nparticles": 16, "particle_mass": 1.67e-27,
        "particle_charge": 1.602e-19}
EM = dict(grid_shape=(32, 32), cell_size=(0.5, 0.5), dt=0.1, charge=-0.01,
          mass=0.01)


def _pusher_reference():
    """The reference's pusher (tests/test_parallel.py's set-up), its
    state and both substeps' uniforms, and its single-device step."""
    from fusion_sim_tpu.models.pusher import (CylindricalParticlePusher,
                                              make_step_fn)
    from fusion_sim_tpu.ops.deposit import deposit_moments
    from fusion_sim_tpu.ops.rng import substep_uniforms

    sim = CylindricalParticlePusher(SPEC, seed=3)
    n = SPEC["nparticles"] ** 2
    rng = np.random.default_rng(0)
    sim.set({
        "position": 0.2 * (rng.random((n, 3)) - 0.5) + np.array([0, 0, 1.0]),
        "velocity": 0.002 * (rng.random((n, 3)) - 0.5),
        "source_pdf": np.ones((SPEC["nr"], SPEC["nz"]), np.float32),
    })
    sim.add_bz(0.05)
    sim.precalc()
    r1, key = substep_uniforms(sim.state.key, n)
    r2, _ = substep_uniforms(key, n)
    ref = make_step_fn(sim.spec)(sim.fields, sim.state)
    moments = deposit_moments(ref.position, ref.velocity, SPEC["nr"],
                              SPEC["nz"])
    return (sim.get_state(), [np.asarray(r1), np.asarray(r2)],
            {k: np.asarray(v) for k, v in ref._asdict().items()
             if k != "key"}, np.asarray(moments))


def _em_reference():
    from fusion_sim_tpu.models import electromagnetic as em

    rng = np.random.default_rng(1)
    pos = (rng.random((1024, 2)) * 32).astype(np.float32)
    vel = (0.1 * rng.standard_normal((1024, 3))).astype(np.float32)
    config = em.EMConfig(**EM)
    ref = em.make_step_fn(config)(em.ElectromagneticPIC(config, pos,
                                                        vel).state)
    return pos, vel, np.asarray(ref.e), np.asarray(ref.position)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    blob, rands, dp_ref, moments = _pusher_reference()
    pos, vel, em_e, em_pos = _em_reference()
    inputs = {"spec": SPEC, "pusher": blob, "rands": rands,
              "em": {"config": EM, "position": pos, "velocity": vel}}
    ranks = run_world(4, parallel_body, inputs,
                      tmp_path_factory.mktemp("parallel"))
    return {"ranks": ranks, "dp": dp_ref, "moments": moments,
            "em_e": em_e, "em_position": em_pos}


def _shard_map(fn, n, in_specs, out_specs, *args, axes=("space",),
               shape=None):
    import jax
    from jax import shard_map
    from fusion_sim_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n, axes, shape=shape)
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs))(*args)


def test_world_present(world):
    for r, out in enumerate(world["ranks"]):
        assert out["world"] == 4 and out["backend"] == "gloo", r


def test_particle_dp_pusher_matches_single_device(world):
    """Each rank steps its quarter of the rows with the replicated fields;
    the gathered rows equal the reference's single-device step (its own
    uniforms, split the same way), and the all_reduce of the ranks'
    moment deposits equals its deposit of all rows."""
    out, ref = world["ranks"][0], world["dp"]
    assert out["dp_placements"] == (True, True, True)
    # the pusher tests' tolerance: XLA's FMA contraction on the rotations
    np.testing.assert_allclose(out["dp_position"], ref["position"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["dp_velocity"], ref["velocity"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out["dp_alive"], ref["alive"])
    for r in world["ranks"][1:]:
        np.testing.assert_array_equal(r["dp_position"], out["dp_position"])
    scale = np.abs(world["moments"]).max()
    np.testing.assert_allclose(out["dp_moments"], world["moments"],
                               rtol=0, atol=1e-5 * scale)


def test_spatially_placed_em_step_matches(world):
    """The EM state placed over the ring (particles and fields split on
    x) round-trips through ``full_tensor()``, and the step on it equals the
    reference's step at the reference test's tolerances."""
    for out in world["ranks"]:
        assert out["em_roundtrip"] and out["em_local_rows"] == (256, 2)
    out = world["ranks"][0]
    np.testing.assert_allclose(out["em_e"], world["em_e"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out["em_position"], world["em_position"],
                               rtol=1e-6, atol=1e-6)


def _ring_ranks(world, n):
    """The ranks of the ring of ``n`` whose results stand for it: all
    four for the ring of four, (0, 1) and (2, 3) for the rings of two."""
    return [world["ranks"][:4]] if n == 4 else [world["ranks"][0:2],
                                                world["ranks"][2:4]]


@pytest.mark.parametrize("n", [2, 4])
def test_with_halo_matches_roll_and_reference(world, n):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fusion_sim_tpu.parallel import halo

    x = np.arange(8.0 * n, dtype=np.float32).reshape(-1, 1) * np.ones(
        (1, 4), np.float32)
    ref = np.asarray(_shard_map(lambda a: halo.with_halo(a, "space", 2), n,
                                P("space", None), P("space", None),
                                jnp.asarray(x))).reshape(n, 12, 4)
    xb = x.reshape(n, 8, 4)
    for ring in _ring_ranks(world, n):
        for s, out in enumerate(ring):
            got = out[f"halo{n}"]
            np.testing.assert_array_equal(got, ref[s])
            np.testing.assert_array_equal(got[2:10], xb[s])
            np.testing.assert_array_equal(got[:2], xb[(s - 1) % n, -2:])
            np.testing.assert_array_equal(got[10:], xb[(s + 1) % n, :2])


@pytest.mark.parametrize("n", [2, 4])
def test_accumulate_apron_matches_reference(world, n):
    """Random aprons fold onto the neighbours exactly as the reference
    folds them, and the total is conserved."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fusion_sim_tpu.parallel import halo

    padded = np.random.default_rng(7).standard_normal(
        (n, 12, 3)).astype(np.float32)
    ref = np.asarray(_shard_map(
        lambda a: halo.accumulate_apron(a, "space", 2), n, P("space", None),
        P("space", None), jnp.asarray(padded.reshape(-1, 3)))).reshape(
            n, 8, 3)
    for ring in _ring_ranks(world, n):
        got = np.stack([out[f"apron{n}"] for out in ring])
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got.sum(), padded.sum(), rtol=1e-5)


def _migrate_reference(n, cap, movers):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fusion_sim_tpu.parallel import migration

    ids, alive, gl, gr = ring_migration_inputs(n, 16, movers)

    def f(arr, alv, g_l, g_r):
        res = migration.migrate_ring((arr,), alv, g_l, g_r, "space", cap)
        return res.arrays[0], res.alive, res.overflow[None]

    p2, p1 = P("space", None), P("space")
    out = _shard_map(f, n, (p2, p1, p1, p1), (p2, p1, p1),
                     *map(jnp.asarray, (ids, alive, gl, gr)))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("n", [2, 4])
def test_migration_ring_matches_reference(world, n):
    """Row for row against the reference (stable sorts on both sides):
    arrivals land in the same slots, leavers are gone, the population is
    conserved and nothing overflows."""
    arr, alive, ovf = _migrate_reference(n, 4, {0: "l", 1: "r", 2: "r"})
    for ring in _ring_ranks(world, n):
        for s, out in enumerate(ring):
            got_arr, got_alive, got_ovf = out[f"ring{n}"]
            np.testing.assert_array_equal(got_arr, arr[16 * s:16 * s + 16])
            np.testing.assert_array_equal(got_alive,
                                          alive[16 * s:16 * s + 16])
            assert got_ovf == ovf[s] == 0
            ids_here = set(got_arr[got_alive, 0].astype(int).tolist())
            assert ((s - 1) % n) * 16 + 1 in ids_here
            assert ((s + 1) % n) * 16 + 0 in ids_here
            assert s * 16 + 0 not in ids_here
        live = np.concatenate([o[f"ring{n}"][0][o[f"ring{n}"][1], 0]
                               for o in ring])
        assert sorted(live.astype(int).tolist()) == list(range(16 * n))


@pytest.mark.parametrize("n", [2, 4])
def test_migration_overflow_reported(world, n):
    """Three right-movers a shard through a buffer of two: one dropped a
    shard, counted as the reference counts it."""
    arr, alive, ovf = _migrate_reference(n, 2, {0: "r", 1: "r", 2: "r"})
    for ring in _ring_ranks(world, n):
        got = [out[f"ovf{n}"] for out in ring]
        assert [g[2] for g in got] == ovf.tolist() == [1] * n
        for s, (g_arr, g_alive, _) in enumerate(got):
            np.testing.assert_array_equal(g_arr, arr[16 * s:16 * s + 16])
            np.testing.assert_array_equal(g_alive, alive[16 * s:16 * s + 16])


def test_halo_2d_corners(world):
    """with_halo_2d on the 2 x 2 mesh fills edges and corners (two hops)
    as the global periodic index does, and as the reference does."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fusion_sim_tpu.parallel import halo

    glob = np.arange(64, dtype=np.float32).reshape(8, 8)
    ref = np.asarray(_shard_map(
        lambda a: halo.with_halo_2d(a, ("sx", "sy"), (2, 2)), 4,
        P("sx", "sy"), P("sx", "sy"), jnp.asarray(glob), axes=("sx", "sy"),
        shape=(2, 2)))
    for rank, out in enumerate(world["ranks"]):
        sx, sy = divmod(rank, 2)
        rows = np.arange(4 * sx - 2, 4 * sx + 6) % 8
        cols = np.arange(4 * sy - 2, 4 * sy + 6) % 8
        np.testing.assert_array_equal(out["halo2d"], glob[np.ix_(rows, cols)])
        np.testing.assert_array_equal(
            out["halo2d"], ref[8 * sx:8 * sx + 8, 8 * sy:8 * sy + 8])


def test_accumulate_apron_2d_matches_global_fold(world):
    """The two-axis fold (corners included) equals a global periodic
    scatter of every shard's padded block, and the reference's fold, to
    f32 rounding (a corner cell sums three contributions)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fusion_sim_tpu.parallel import halo

    padded = np.random.default_rng(7).standard_normal(
        (2, 2, 8, 8)).astype(np.float32)
    glob = np.zeros((8, 8), np.float32)
    for sx in range(2):
        for sy in range(2):
            for i in range(8):
                for j in range(8):
                    glob[(4 * sx + i - 2) % 8, (4 * sy + j - 2) % 8] += \
                        padded[sx, sy, i, j]
    stacked = np.block([[padded[0, 0], padded[0, 1]],
                        [padded[1, 0], padded[1, 1]]])
    ref = np.asarray(_shard_map(
        lambda a: halo.accumulate_apron_2d(a, ("sx", "sy"), (2, 2)), 4,
        P("sx", "sy"), P("sx", "sy"), jnp.asarray(stacked),
        axes=("sx", "sy"), shape=(2, 2)))
    for rank, out in enumerate(world["ranks"]):
        sx, sy = divmod(rank, 2)
        blk = slice(4 * sx, 4 * sx + 4), slice(4 * sy, 4 * sy + 4)
        np.testing.assert_allclose(out["apron2d"], glob[blk], rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(out["apron2d"], ref[blk])


def test_migrate_grid_diagonal(world):
    """The two-phase migration routes the diagonal mover over both axes;
    every rank's rows equal the reference shard's, row for row."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fusion_sim_tpu.parallel import migration

    val, dest, alive = grid_migration_inputs()

    def mask_fn(arrays, k):
        mine = jax.lax.axis_index("sx" if k == 0 else "sy")
        move = arrays[1 + k].astype(jnp.int32) != mine
        return jnp.zeros_like(move), move

    def f(v, dx, dy, alv):
        res = migration.migrate_grid((v, dx, dy), alv, mask_fn, ("sx", "sy"),
                                     4)
        return (*res.arrays, res.alive, res.overflow[None])

    spec = P(("sx", "sy"))
    ref = [np.asarray(o) for o in _shard_map(
        f, 4, (spec,) * 4, (spec,) * 5, jnp.asarray(val),
        jnp.asarray(dest[:, 0]), jnp.asarray(dest[:, 1]), jnp.asarray(alive),
        axes=("sx", "sy"), shape=(2, 2))]
    total = 0
    for rank, out in enumerate(world["ranks"]):
        sl = slice(8 * rank, 8 * rank + 8)
        for got, want in zip(out["grid"][:4], ref[:4]):
            np.testing.assert_array_equal(got, want[sl])
        assert out["grid"][4] == ref[4][rank] == 0
        live = out["grid"][3]
        np.testing.assert_array_equal(out["grid"][1][live], rank // 2)
        np.testing.assert_array_equal(out["grid"][2][live], rank % 2)
        total += int(live.sum())
    assert total == int(alive.sum())
    assert 0.0 in world["ranks"][3]["grid"][0][world["ranks"][3]["grid"][3]]
