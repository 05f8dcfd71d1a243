"""Rank bodies of the port's multi-rank CPU tests, and the world that runs
them (not a test module: pytest collects nothing here).

``run_world(n, body, inputs, tmp_dir)`` starts ``n`` ranks with
``torch.multiprocessing`` on one gloo world (a file store in ``tmp_dir``,
one torch thread a rank), calls ``body(rank, inputs)`` in each and returns
the ranks' results (numpy arrays, counts) in rank order.  A hung rank dumps
its stack and exits after ``RANK_TIMEOUT_S``; a collective that waits
longer than ``COLLECTIVE_TIMEOUT_S`` raises, so a fault fails the test
instead of hanging the suite.

Nothing here imports JAX: the spawned ranks import this module only.  The
tests build the reference's inputs and results in the pytest process and
compare.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120


def _rank_main(rank, n, tmp_dir, body, inputs):
    faulthandler.dump_traceback_later(RANK_TIMEOUT_S, exit=True)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp_dir, 'store')}",
        rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        result = body(rank, inputs)
        with open(os.path.join(tmp_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()


def run_world(n: int, body, inputs, tmp_dir) -> list:
    tmp_dir = str(tmp_dir)
    mp.spawn(_rank_main, args=(n, tmp_dir, body, inputs), nprocs=n,
             join=True)
    out = []
    for r in range(n):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(t):
    return t.detach().cpu().numpy()


def _pairs(rank):
    """Rings of two: ranks (0, 1) and (2, 3) of a world of four (every
    rank creates both groups, as ``new_group`` requires)."""
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return groups[rank // 2]


def _singles(rank):
    groups = [dist.new_group([r]) for r in range(dist.get_world_size())]
    return groups[rank]


# -- parallel/: tests/test_torch_parallel.py ------------------------------------

def ring_migration_inputs(n_shards, n_per, movers):
    """The reference test's rows: id = shard * n_per + local index, all
    alive; ``movers`` maps a local index to 'l' or 'r' on every shard."""
    ids = np.arange(n_shards * n_per, dtype=np.float32).reshape(-1, 1)
    go_l = np.zeros(n_shards * n_per, bool)
    go_r = np.zeros(n_shards * n_per, bool)
    for s in range(n_shards):
        for k, side in movers.items():
            (go_l if side == "l" else go_r)[s * n_per + k] = True
    return ids, np.ones(n_shards * n_per, bool), go_l, go_r


def grid_migration_inputs(n_per=8):
    """tests/test_parallel.py::test_migrate_grid_diagonal's rows: value,
    destination (sx, sy); the back half of every shard dead."""
    n = 4 * n_per
    val = np.arange(n, dtype=np.float32)
    dest = np.zeros((n, 2), np.float32)
    for s in range(4):
        dest[s * n_per:(s + 1) * n_per] = divmod(s, 2)
    dest[0] = (1, 1)
    dest[1] = (1, 0)
    dest[3 * n_per] = (0, 1)
    alive = np.ones(n, bool)
    for s in range(4):
        alive[s * n_per + n_per // 2:(s + 1) * n_per] = False
    return val, dest, alive


def parallel_body(rank, inp):
    from fusion_sim_torch.models import electromagnetic as tem
    from fusion_sim_torch.models import pusher as tpm
    from fusion_sim_torch.ops.deposit import deposit_moments
    from fusion_sim_torch.parallel import halo, migration, sharding
    from fusion_sim_torch.parallel.mesh import all_gather_rows, make_mesh

    out = {"world": dist.get_world_size(), "backend": dist.get_backend()}
    mesh4 = make_mesh(4, ("space",), device="cpu")
    rings = {4: mesh4.get_group(), 2: _pairs(rank)}
    for n, g in rings.items():
        me = dist.get_rank(g)
        x = np.arange(8.0 * n, dtype=np.float32).reshape(-1, 1) * np.ones(
            (1, 4), np.float32)
        out[f"halo{n}"] = _np(halo.with_halo(
            torch.tensor(x[8 * me:8 * (me + 1)]), g, 2))
        padded = np.random.default_rng(7).standard_normal(
            (n, 12, 3)).astype(np.float32)
        out[f"apron{n}"] = _np(halo.accumulate_apron(
            torch.tensor(padded[me]), g, 2))
        for name, cap, movers in (("ring", 4, {0: "l", 1: "r", 2: "r"}),
                                  ("ovf", 2, {0: "r", 1: "r", 2: "r"})):
            ids, alive, gl, gr = ring_migration_inputs(n, 16, movers)
            sl = slice(16 * me, 16 * (me + 1))
            res = migration.migrate_ring(
                (torch.tensor(ids[sl]),), torch.tensor(alive[sl]),
                torch.tensor(gl[sl]), torch.tensor(gr[sl]), g, cap)
            out[f"{name}{n}"] = (_np(res.arrays[0]), _np(res.alive),
                                 int(res.overflow))

    # particle data-parallel pusher: each rank its rows, fields replicated
    blob = inp["pusher"]
    state, fields = tpm.pusher_state_from_numpy(blob, "cpu")
    mesh_d = make_mesh(4, ("data",), device="cpu")
    ds = sharding.shard_pusher_state(state, mesh_d)
    df = sharding.replicate_pusher_fields(fields, mesh_d)
    out["dp_placements"] = (ds.position.placements[0].is_shard(0),
                            ds.moments_avg.placements[0].is_replicate(),
                            df.b.placements[0].is_replicate())
    local = tpm.PusherState(*(t.to_local() for t in ds))
    rands = [sharding.shard_fields_spatial(torch.tensor(r), mesh_d, "data")
             .to_local() for r in inp["rands"]]
    stepped = tpm.make_step_fn(tpm.PusherSpec(**inp["spec"]))(
        sharding._tree_map(lambda t: t.to_local(), df), local, rands)
    g_d = mesh_d.get_group()
    out["dp_position"] = _np(all_gather_rows(stepped.position, g_d))
    out["dp_velocity"] = _np(all_gather_rows(stepped.velocity, g_d))
    out["dp_alive"] = _np(all_gather_rows(stepped.alive, g_d))
    moments = deposit_moments(stepped.position, stepped.velocity,
                              inp["spec"]["nr"], inp["spec"]["nz"])
    dist.all_reduce(moments, group=g_d)
    out["dp_moments"] = _np(moments)

    # spatial EM placement: full_tensor() round-trips; the step on it
    em = inp["em"]
    cfg = tem.EMConfig(**em["config"])
    sim = tem.ElectromagneticPIC(cfg, em["position"], em["velocity"],
                                 device="cpu")
    placed = sharding.shard_em_state(sim.state, mesh4, particle_axis="space",
                                     space_axis="space")
    out["em_local_rows"] = tuple(placed.position.to_local().shape)
    full = placed._replace(**{k: getattr(placed, k).full_tensor()
                              for k in ("position", "velocity", "e", "b")})
    out["em_roundtrip"] = all(
        torch.equal(getattr(full, k), getattr(sim.state, k))
        for k in ("position", "velocity", "e", "b"))
    after = tem.make_step_fn(cfg)(full)
    out["em_e"], out["em_position"] = _np(after.e), _np(after.position)

    # the 2 x 2 mesh: two-hop halos and folds, the diagonal migration
    mesh22 = make_mesh(4, ("sx", "sy"), shape=(2, 2), device="cpu")
    sx, sy = mesh22.get_coordinate()
    groups = (mesh22.get_group("sx"), mesh22.get_group("sy"))
    glob = np.arange(64, dtype=np.float32).reshape(8, 8)
    out["halo2d"] = _np(halo.with_halo_2d(
        torch.tensor(glob[4 * sx:4 * sx + 4, 4 * sy:4 * sy + 4]), groups,
        (2, 2)))
    padded = np.random.default_rng(7).standard_normal(
        (2, 2, 8, 8)).astype(np.float32)
    out["apron2d"] = _np(halo.accumulate_apron_2d(
        torch.tensor(padded[sx, sy]), groups, (2, 2)))
    val, dest, alive = grid_migration_inputs()
    sl = slice(8 * rank, 8 * rank + 8)
    coords = (sx, sy)

    def mask_fn(arrays, k):
        move = arrays[1 + k].to(torch.int32) != coords[k]
        return torch.zeros_like(move), move   # a ring of 2: one hop

    res = migration.migrate_grid(
        (torch.tensor(val[sl]), torch.tensor(dest[sl, 0]),
         torch.tensor(dest[sl, 1])), torch.tensor(alive[sl]), mask_fn,
        groups, 4)
    out["grid"] = (*(_np(a) for a in res.arrays), _np(res.alive),
                   int(res.overflow))
    return out


# -- the sharded ES model: tests/test_torch_es_sharded.py ----------------------

def es_body(rank, inp):
    """Every case of tests/test_torch_es_sharded.py on this rank: the
    rings of four first, then the rings of two ((0, 1) and (2, 3) run
    different cases), then the single shards."""
    from fusion_sim_torch.ops.solvers import poisson_fft, poisson_fft_sharded
    from fusion_sim_torch.parallel.mesh import make_mesh

    out = {}
    ring4 = make_mesh(4, ("space",), device="cpu")
    pair = _pairs(rank)
    single = _singles(rank)
    for n, g in ((4, ring4), (2, pair)):
        me = dist.get_rank(g) if n == 2 else rank
        for shape, dx in (((64, 64), (0.5, 0.25)),
                          ((32, 64, 16), (0.5, 0.25, 1.0))):
            rho = np.random.default_rng(1).standard_normal(shape).astype(
                np.float32)
            rho -= rho.mean()
            slab = shape[0] // n
            out[("poisson", n, len(shape))] = (
                _np(poisson_fft_sharded(
                    torch.tensor(rho[slab * me:slab * (me + 1)]), shape, dx,
                    g)),
                _np(poisson_fft(torch.tensor(rho), dx))[
                    slab * me:slab * (me + 1)])
    for case in inp["cases"]:
        group = {4: ring4, 2: pair, 1: single}[case["n_shards"]]
        if case.get("ranks") is not None and rank not in case["ranks"]:
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out[case["name"]] = _run_es_case(case, group)
        out[case["name"]]["warnings"] = [str(w.message) for w in caught]
    return out


def _es_config(case):
    from fusion_sim_torch.models import electrostatic as tes
    from fusion_sim_torch.models.electrostatic_sharded import ShardedESConfig
    from fusion_sim_torch.ops.sorted_deposit import Tiling2D, Tiling3D

    kw = dict(case["config"])
    base = tes.ESConfig(**kw.pop("base"))
    tiling = kw.pop("tiling", None)
    if tiling is not None:
        tiling = (Tiling2D(**tiling) if "tile_r" in tiling
                  else Tiling3D(**tiling))
    return ShardedESConfig(base=base, tiling=tiling, **kw)


def _run_es_case(case, group):
    """One case on one ring: the constructor's layout, then (given the
    reference's initial state) ``steps`` single steps from that state and
    ``more`` shell steps after them; every stage's local state and the
    live particles gathered over the ring."""
    from fusion_sim_torch.models.electrostatic_sharded import (
        ShardedElectrostaticPIC)

    cfg = _es_config(case)
    res = {}
    sim = ShardedElectrostaticPIC(cfg, group, case["position"],
                                  case["velocity"], device="cpu")
    res["built"] = sim.local_state() if sim.sorted else None
    if case.get("expect_raise"):
        try:
            sim.step(case["steps"])
            res["raised"] = None
        except RuntimeError as exc:
            res["raised"] = str(exc)
        return res
    if case.get("initial") is not None:
        sim = ShardedElectrostaticPIC.from_state(cfg, group, case["initial"],
                                                 device="cpu")
        for _ in range(case["steps"]):
            if cfg.repair:
                sim.step(1)
            else:
                sim.state = sim._step(sim.state)
        res["stepped"] = sim.local_state()
        if cfg.backend == "pallas":
            res["seed_rho"] = _np(sim._seed_rho(sim.state))
    else:
        sim.step(case["steps"])
    for _ in range(case.get("more", 0)):
        sim.step(1)
    res["final"] = sim.local_state()
    res["particles"] = sim.gather_particles()
    res["invariants"] = sim.check_invariants()
    return res


# -- the sharded repair: tests/test_torch_repair.py -----------------------------

def stacked_migration_body(rank, inp):
    """tests/test_repair.py::test_migrate_ring_stacked_seat_spare_drop's
    two shards: every arrival bound for tile 0."""
    from fusion_sim_torch.parallel.migration import migrate_ring_stacked

    sl = slice(8 * rank, 8 * rank + 8)

    def t(key, dtype):
        return torch.tensor(np.asarray(inp[key])[sl], dtype=dtype)

    pos = t("pos", torch.float32)
    res = migrate_ring_stacked(
        (pos, torch.zeros_like(pos)), t("alive", torch.bool),
        t("go_l", torch.bool), t("go_r", torch.bool), None, 4,
        t("tile_id", torch.int32), inp["n_tiles"],
        lambda arrs: torch.zeros(arrs[0].shape[0], dtype=torch.int64),
        torch.tensor(inp["free_idx"][rank], dtype=torch.int64),
        torch.tensor(inp["free_cnt"][rank], dtype=torch.int64),
        torch.tensor(inp["spare_idx"][rank], dtype=torch.int64),
        torch.tensor(inp["spare_cnt"][rank], dtype=torch.int64))
    return {"pos": _np(res.arrays[0]), "alive": _np(res.alive),
            "overflow": int(res.overflow), "free_idx": _np(res.free_idx),
            "free_cnt": _np(res.free_cnt), "spare_idx": _np(res.spare_idx),
            "spare_cnt": _np(res.spare_cnt),
            "placed_tile": int(res.placed_tile),
            "placed_spare": int(res.placed_spare)}


# -- the sharded EM and two-axis models: tests/test_torch_em_sharded.py and
# tests/test_torch_sharded2d.py --------------------------------------------

def _tiling(t):
    from fusion_sim_torch.ops.sorted_deposit import Tiling2D, Tiling3D

    if t is None:
        return None
    return Tiling2D(**t) if "tile_r" in t else Tiling3D(**t)


def _model(kind):
    """(base config class, sharded config class, shell class) of a model
    kind: 'em' (slabs), 'es2d' or 'em2d' (the two-axis mesh)."""
    if kind == "em":
        from fusion_sim_torch.models import electromagnetic as m
        from fusion_sim_torch.models import electromagnetic_sharded as s
        return m.EMConfig, s.ShardedEMConfig, s.ShardedElectromagneticPIC
    if kind == "es2d":
        from fusion_sim_torch.models import electrostatic as m
        from fusion_sim_torch.models import electrostatic_sharded2d as s
        return m.ESConfig, s.ShardedESConfig2D, s.ShardedElectrostaticPIC2D
    from fusion_sim_torch.models import electromagnetic as m
    from fusion_sim_torch.models import electromagnetic_sharded2d as s
    return m.EMConfig, s.ShardedEMConfig2D, s.ShardedElectromagneticPIC2D


def sharded_config(kind, config):
    base_cls, cfg_cls, _ = _model(kind)
    kw = dict(config)
    base = base_cls(**kw.pop("base"))
    tiling = _tiling(kw.pop("tiling", None))
    if "mesh_shape" in kw:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    return cfg_cls(base=base, tiling=tiling, **kw)


def _owned(sim):
    """Every live row lies in this rank's block."""
    st = sim.state
    if hasattr(sim, "_m2"):
        lows, slabs = sim._m2.lows, sim.config.slabs
    else:
        lows, slabs = (sim._ring.x_lo,), (sim.config.slab,)
    p = st.position[st.alive]
    return all(bool(((p[:, a] >= lo) & (p[:, a] < lo + s)).all())
               for a, (lo, s) in enumerate(zip(lows, slabs)))


def run_case(kind, case, mesh):
    """One case on one mesh (or ring): the constructor's state; then
    (given the reference's initial state, else from the constructor's)
    ``steps`` single steps, whether every live row stayed in its block
    after each; ``more`` shell steps after them; every stage's local state
    and the live particles gathered over the mesh."""
    cfg = sharded_config(kind, case["config"])
    cls = _model(kind)[2]
    res = {}
    sim = cls(cfg, mesh, case["position"], case["velocity"], device="cpu")
    res["built"] = sim.local_state()
    if case.get("expect_raise"):
        try:
            sim.step(case["steps"])
            res["raised"] = None
        except RuntimeError as exc:
            res["raised"] = str(exc)
        return res
    if case.get("initial") is not None:
        sim = cls.from_state(cfg, mesh, case["initial"], device="cpu")
    res["owned"] = []
    for _ in range(case["steps"]):
        if getattr(cfg, "repair", False):
            sim.step(1)
        else:
            sim.state = sim._step(sim.state)
        res["owned"].append(_owned(sim))
    if sim.sorted and not getattr(cfg, "repair", False):
        sim._since_sort = case["steps"]   # the shell's cadence goes on
    res["stepped"] = sim.local_state()
    if getattr(cfg, "backend", None) == "pallas":
        res["seed_rho"] = _np(sim._seed_rho(sim.state))
    for _ in range(case.get("more", 0)):
        sim.step(1)
    res["final"] = sim.local_state()
    res["particles"] = sim.gather_particles()
    res["invariants"] = sim.check_invariants()
    return res


def _cases_on(inp, rank, meshes, body):
    out = {}
    for case in inp["cases"]:
        if case.get("ranks") is not None and rank not in case["ranks"]:
            continue
        mesh = meshes[case["mesh"]]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out[case["name"]] = body(case, mesh)
        out[case["name"]]["warnings"] = [str(w.message) for w in caught]
    return out


def em_body(rank, inp):
    """Every case of tests/test_torch_em_sharded.py on this rank: rings of
    four, rings of two ((0, 1) and (2, 3) run different cases at once),
    single shards."""
    from fusion_sim_torch.parallel.mesh import make_mesh

    meshes = {4: make_mesh(4, ("space",), device="cpu"), 2: _pairs(rank),
              1: _singles(rank)}
    return _cases_on(inp, rank, meshes,
                     lambda case, mesh: run_case("em", case, mesh))


def mesh2d_body(rank, inp):
    """Every case of tests/test_torch_sharded2d.py on this rank: the (2,
    2), (4, 1) and (1, 4) meshes of the world of four, and (1, 1) meshes
    on single ranks (every rank builds all four, as group creation
    requires)."""
    from torch.distributed.device_mesh import DeviceMesh

    from fusion_sim_torch.models import electrostatic_sharded
    from fusion_sim_torch.parallel.mesh import make_mesh

    names = ("sx", "sy")
    meshes = {shape: make_mesh(4, names, shape=shape, device="cpu")
              for shape in ((2, 2), (4, 1), (1, 4))}
    singles = [DeviceMesh("cpu", torch.tensor([[r]]), mesh_dim_names=names)
               for r in range(dist.get_world_size())]
    meshes[(1, 1)] = singles[rank]
    dft_max = electrostatic_sharded.GATHERED_DFT_MAX

    def body(case, mesh):
        if case.get("bad_mesh"):
            cfg = sharded_config(case["kind"], case["config"])
            try:
                _model(case["kind"])[2](cfg, mesh, case["position"],
                                        case["velocity"], device="cpu")
                return {"raised": None}
            except ValueError as exc:
                return {"raised": str(exc)}
        # the pencil route on a small 2D grid (the reference test patches
        # the same switch)
        electrostatic_sharded.GATHERED_DFT_MAX = case.get("dft_max",
                                                          dft_max)
        try:
            return run_case(case["kind"], case, mesh)
        finally:
            electrostatic_sharded.GATHERED_DFT_MAX = dft_max

    return _cases_on(inp, rank, meshes, body)


# -- comparisons in the pytest process (numpy only) -----------------------------

def run_world_beside(n: int, body, inputs, tmp_dir, work):
    """``run_world`` in a thread while this process runs ``work()`` (the
    reference's side); returns ``(ranks, work's result)``."""
    import threading

    box = {}

    def target():
        try:
            box["ranks"] = run_world(n, body, inputs, tmp_dir)
        except BaseException as exc:  # re-raised in the caller's thread
            box["error"] = exc

    thread = threading.Thread(target=target)
    thread.start()
    try:
        done = work()
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], done


def stack(parts, key):
    return np.concatenate([p[key] for p in parts])


def stack_blocks(parts, key, mesh_shape):
    """The global grid from the ranks' blocks (shards in mesh order)."""
    sx, sy = mesh_shape
    rows = [np.concatenate([parts[ix * sy + iy][key] for iy in range(sy)],
                           axis=1) for ix in range(sx)]
    return np.concatenate(rows, axis=0)


def match_rows(got, want, atol):
    """Each live particle of ``got`` (positions, velocities) has its own
    nearest reference row, within ``atol`` in every coordinate."""
    from scipy.spatial import cKDTree

    assert got[0].shape == want[0].shape, (got[0].shape, want[0].shape)
    rows_g = np.concatenate(got, axis=1)
    rows_w = np.concatenate(want, axis=1)
    _, idx = cKDTree(want[0]).query(got[0])
    assert len(np.unique(idx)) == len(idx)
    np.testing.assert_allclose(rows_g, rows_w[idx], rtol=0, atol=atol)


def tile_segments(state):
    """{tile: the segment's live rows, sorted} of a layout."""
    tid, alive = state["tile_id"], state["alive"]
    rows = np.concatenate([state["position"], state["velocity"]], axis=1)
    out = {}
    for t in np.unique(tid[alive]):
        seg = rows[(tid == t) & alive]
        out[int(t)] = seg[np.lexsort(seg[:, ::-1].T)]
    return out


def check_layout(got, want):
    """Two layouts of one shard: the same tile ids and validity, each tile
    segment the same set of rows (the sorts order rows inside a tile
    differently)."""
    np.testing.assert_array_equal(got["tile_id"], want["tile_id"])
    np.testing.assert_array_equal(got["alive"], want["alive"])
    have, need = tile_segments(got), tile_segments(want)
    assert have.keys() == need.keys()
    for t in need:
        np.testing.assert_array_equal(have[t], need[t])


COUNTS = ("alive", "tile_id", "overflow", "spill", "unplaced", "free_cnt",
          "free_idx", "spare_cnt", "spare_idx")


def check_rows(got: dict, want: dict, atol: float, field_tol: float):
    """Two states row for row: the counts and layout exactly, live rows'
    positions and velocities within ``atol``, dead rows 0, ``max_disp``
    to f32 rounding, grid arrays within ``field_tol`` of their max."""
    for key in COUNTS:
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    alive = want["alive"]
    for key in ("position", "velocity"):
        np.testing.assert_allclose(got[key][alive], want[key][alive],
                                   rtol=0, atol=atol, err_msg=key)
        np.testing.assert_array_equal(got[key][~alive], 0.0)
    np.testing.assert_allclose(got["max_disp"], want["max_disp"], rtol=1e-5)
    for key in ("e", "b", "rho"):
        if key in want:
            scale = max(np.abs(want[key]).max(), 1e-30)
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=field_tol * scale, err_msg=key)
