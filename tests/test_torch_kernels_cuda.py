"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

Without a CUDA card every test here skips (a kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fused_pic
from fusion_sim_torch.ops.sorted_deposit import Tiling2D, build_padded_layout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vscale", [0.5, 8.0])   # no spill / heavy spill
def test_fused_es2d_substep_kernel_matches_plain(cuda, vscale):
    """Built with -fmad=false and the plain version's operation order:
    positions, velocities and in_win bit for bit; rho differs only by the
    order of its atomic sums, 1e-5 of max|rho|."""
    shape = (64, 128)
    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    rng = np.random.default_rng(4)
    n = 4096
    pos = torch.tensor(rng.random((n, 2)) * np.array(shape),
                       dtype=torch.float32, device=cuda)
    vel = torch.tensor(vscale * rng.standard_normal((n, 2)),
                       dtype=torch.float32, device=cuda)
    e_grid = torch.tensor(rng.standard_normal((*shape, 2)),
                          dtype=torch.float32, device=cuda)
    tid, pos_p, v0, v1, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], derive_valid=True)
    w = torch.where(valid, 1.5, 0.0).to(torch.float32)
    args = (e_grid, pos_p, torch.stack([v0, v1], -1), w, tid, shape,
            tiling, 0.25, 0.5, 0.5)
    before = fused_pic.LAUNCHES
    got = fused_pic.fused_es2d_substep(*args)
    assert fused_pic.LAUNCHES == before + 1
    plain = fused_pic.fused_es2d_substep_plain(*args)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    if vscale > 1:
        assert int((~plain[3] & valid).sum()) > 100, "needs actual spill"


@pytest.mark.cuda
def test_fused_es2d_substep_kernel_rejects_bad_inputs(cuda):
    shape = (64, 64)
    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    n = 256
    e_grid = torch.zeros((*shape, 2), device=cuda)
    pos = torch.zeros((n, 2), device=cuda)
    w = torch.zeros((n,), device=cuda)
    tid = torch.zeros((n,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="tile_id"):
        fused_pic.fused_es2d_substep(e_grid, pos, pos, w, tid.long(), shape,
                                     tiling, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="position"):
        fused_pic.fused_es2d_substep(e_grid, pos.t().contiguous().t(), pos,
                                     w, tid, shape, tiling, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="e_grid"):
        fused_pic.fused_es2d_substep(e_grid.cpu(), pos, pos, w, tid, shape,
                                     tiling, 0.1, 0.1, 0.1)


def _pusher_layout(cuda, backend, tiling, vscale=1.0):
    """A small default scenario on the card in the sorted layout."""
    from fusion_sim_torch.models.pusher import CylindricalParticlePusher
    from fusion_sim_torch.scenarios import apply_default_scenario

    sim = CylindricalParticlePusher(
        {"radius": 1.0, "height": 2.0, "nr": 64, "nz": 128, "dt": 2e-9,
         "nparticles": 64, "particle_mass": 1.67e-27,
         "particle_charge": 1.602e-19}, loop_field_mode="exact",
        device=cuda)
    apply_default_scenario(sim)
    sim.set({"velocity": vscale * 0.002 * np.random.default_rng(3).random(
        (sim.spec.n_total, 3))})
    sim.enable_sorted_path(tiling=tiling, resort_every=4, backend=backend)
    return sim, sim._sorted_state


@pytest.mark.cuda
@pytest.mark.parametrize("vscale", [1.0, 300.0])  # scenario / heavy spill
def test_fused_pusher_substep_kernel_matches_plain(cuda, vscale):
    """Built with -fmad=false and the plain version's operation order:
    in_win, sink, positions and velocities bit for bit on valid rows."""
    from fusion_sim_torch.ops import fused_pusher

    tiling = Tiling2D(tile_r=8, tile_z=16, block=128, margin=3)
    sim, st = _pusher_layout(cuda, "fused", tiling, vscale)
    f = sim.fields
    packed13 = torch.cat([f.coeffs.r1, f.coeffs.r2, f.coeffs.r3, f.coeffs.a,
                          f.sink_mask[..., None]], -1).contiguous()
    alive = st.alive.clone()
    alive[st.valid.nonzero()[:50, 0]] = 0.0           # fresh rows
    rand = torch.rand((st.position.shape[0], 4), device=cuda)
    args = (packed13, st.position, st.velocity, alive, rand, st.tile_id,
            64, 128, tiling, sim.spec.step_factor)
    before = fused_pusher.LAUNCHES
    got = fused_pusher.fused_pusher_substep(*args)
    assert fused_pusher.LAUNCHES == before + 1
    plain = fused_pusher.fused_pusher_substep_plain(*args)
    v = st.valid
    for name, i in (("position", 0), ("velocity", 1), ("sink", 2),
                    ("in_win", 3)):
        assert torch.equal(got[i][v], plain[i][v]), name
    if vscale > 1:
        assert int((~plain[3] & v).sum()) > 100, "needs actual spill"


@pytest.mark.cuda
@pytest.mark.parametrize("mode,channels", [
    ("nearest", (12,)), ("nearest", (1,)), ("cic", (6,)), ("cic", ()),
    ("nearest", (3,)), ("nearest", (6,)), ("nearest", (13,)), ("cic", (1,)),
    ("cic", (3,)), ("cic", (12,)), ("cic", (13,))])
def test_gather2d_kernel_matches_plain(cuda, mode, channels):
    from fusion_sim_torch.ops import sorted_gather

    shape = (64, 128)
    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    rng = np.random.default_rng(5)
    n = 8192
    pos = torch.tensor(rng.random((n, 2)) * np.array(shape),
                       dtype=torch.float32, device=cuda)
    grid = torch.tensor(rng.standard_normal(shape + channels),
                        dtype=torch.float32, device=cuda)
    tid, pos_p, valid, _ = build_padded_layout(pos, shape, tiling,
                                               derive_valid=True)
    # jitter from the seeded generator (the torch stream's draws depend on
    # the tests that ran before)
    jitter = torch.tensor(1.5 * rng.standard_normal(tuple(pos_p.shape)),
                          dtype=torch.float32, device=cuda)
    pos_p = torch.remainder(pos_p + jitter,
                            torch.tensor(shape, device=cuda,
                                         dtype=torch.float32))
    args = (grid, pos_p.contiguous(), tid, shape, tiling, mode)
    before = sorted_gather.LAUNCHES
    got = sorted_gather.gather_sorted_2d_window(*args)
    assert sorted_gather.LAUNCHES == before + 1
    plain = sorted_gather.gather_sorted_2d_window_plain(*args)
    assert torch.equal(got[1], plain[1])
    assert torch.equal(got[0][valid], plain[0][valid])
    assert int((~plain[1] & valid).sum()) > 100, "needs out-of-window rows"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nearest", "cic"])
@pytest.mark.parametrize("n_c", [1, 3, 6, 12, 13])
def test_gather2d_kernel_floor_mod_edges(cuda, mode, n_c):
    """Rows whose x - origin is exactly 0, exactly n, -tiny (mod gives n),
    just below 2n, exactly 2n and beyond, and below -n, on both axes: the
    kernel's conditional +-n and its fmodf fallback give the plain
    version's values and in_win bit for bit."""
    from fusion_sim_torch.ops import sorted_gather
    from fusion_sim_torch.ops.sorted_deposit import window_origins

    shape = (64, 128)
    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    rng = np.random.default_rng(6)
    n = 8192
    pos = torch.tensor(rng.random((n, 2)) * np.array(shape),
                       dtype=torch.float32, device=cuda)
    grid = torch.tensor(rng.standard_normal(shape + (n_c,)),
                        dtype=torch.float32, device=cuda)
    tid, pos_p, valid, _ = build_padded_layout(pos, shape, tiling,
                                               derive_valid=True)
    origins = [o.repeat_interleave(tiling.block).to(torch.float32)
               for o in window_origins(tid, shape, tiling)]
    edges = []
    for nn in shape:
        edges.append(torch.tensor(
            [0.0, nn, -2.0 ** -20, 2 * nn - 0.25, 2 * nn, 2 * nn + 0.5,
             -nn - 0.5, nn - 2.0 ** -18, 0.5], device=cuda))
    rows = valid.nonzero()[:, 0].cpu().numpy()
    pick = torch.tensor(rng.permutation(rows)[:4096], device=cuda)
    k = len(edges[0])
    pos_p = pos_p.clone()
    for a in range(2):
        which = torch.tensor(rng.integers(0, k, pick.numel()), device=cuda)
        pos_p[pick, a] = origins[a][pick] + edges[a][which]
    args = (grid, pos_p.contiguous(), tid, shape, tiling, mode)
    got = sorted_gather.gather_sorted_2d_window(*args)
    plain = sorted_gather.gather_sorted_2d_window_plain(*args)
    assert torch.equal(got[1], plain[1])
    assert torch.equal(got[0][valid], plain[0][valid])
    assert bool(plain[1][pick].any()) and not bool(plain[1][pick].all())


def _em_case(cuda, vscale, shape=(64, 128), n=8192, seed=6):
    from fusion_sim_torch.ops.sorted_deposit import Tiling2D

    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.random((n, 2)) * np.array(shape),
                       dtype=torch.float32, device=cuda)
    vel = torch.tensor(vscale * rng.standard_normal((n, 3)),
                       dtype=torch.float32, device=cuda)
    table = torch.tensor(rng.standard_normal((*shape, 6)),
                         dtype=torch.float32, device=cuda)
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
        derive_valid=True)
    return (table, pos_p, torch.stack([v0, v1, v2], -1).contiguous(), valid,
            tid, shape, tiling, 0.1, 0.1, (0.5, 0.8), -0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("vscale,relativistic,c_light", [
    (0.1, False, 1.0), (1.5, True, 1.0), (12.0, False, 1.0),
    (25.0, True, 60.0)])       # thermal, relativistic, heavy spill (both)
def test_fused_em2d_substep_kernel_matches_plain(cuda, vscale, relativistic,
                                                 c_light):
    """Built with -fmad=false and the plain version's operation order:
    positions, velocities and in_win bit for bit; J differs by the order of
    its atomic sums and the rounding of the in-cell rows' closed form, 1e-5
    of max|J|."""
    from fusion_sim_torch.ops import fused_em

    args = _em_case(cuda, vscale)
    kw = dict(c_light=c_light, relativistic=relativistic)
    before = fused_em.LAUNCHES
    got = fused_em.fused_em2d_substep(*args, **kw)
    assert fused_em.LAUNCHES == before + 1
    plain = fused_em.fused_em2d_substep_plain(*args, **kw)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    if vscale > 10:
        assert int((~plain[3] & args[3]).sum()) > 100, "needs actual spill"


@pytest.mark.cuda
def test_fused_em2d_substep_kernel_rejects_bad_inputs(cuda):
    from fusion_sim_torch.ops import fused_em

    args = list(_em_case(cuda, 0.1, n=256))
    for i, name, bad, exc in (
            (0, "table", args[0].cpu(), ValueError),
            (1, "position", args[1].t().contiguous().t(), ValueError),
            (2, "velocity", args[2][:, :2].contiguous(), ValueError),
            (3, "valid", args[3].float(), TypeError),
            (4, "tile_id", args[4].long(), TypeError)):
        broken = list(args)
        broken[i] = bad
        with pytest.raises(exc, match=name):
            fused_em.fused_em2d_substep(*broken)


def _em2d_layout(cuda, case):
    """The tile-owned B4's edges, on a 64 x 128 grid unless said: (table,
    position, velocity, valid, tile_id, shape, tiling, relativistic,
    c_light).  Every tile's window wraps at the periodic edge, and the
    layouts end in sentinel blocks (the repair layout spreads them)."""
    from fusion_sim_torch.models import electromagnetic as em

    shape, n, vscale, jitter, rel, c = (64, 128), 40960, 0.1, 0.0, False, 1.0
    cell_order = False
    if case == "tile 32 margin 6":   # ~20 blocks a tile
        tiling = Tiling2D(tile_r=32, tile_z=32, block=256, margin=6)
    elif case == "tile 16 margin 7":
        tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=7)
    elif case == "by cell":
        tiling = Tiling2D(tile_r=32, tile_z=32, block=256, margin=6)
        cell_order = True
    elif case == "L1 form":          # 77^2 cells: 512 threads, L1
        shape = (128, 128)
        tiling = Tiling2D(tile_r=64, tile_z=64, block=256, margin=6)
    elif case == "L1 form 256":      # 91^2 cells: 256 threads, L1
        shape = (128, 128)
        tiling = Tiling2D(tile_r=64, tile_z=64, block=256, margin=13)
    elif case == "heavy spill":      # span rows and frozen rows
        tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
        vscale, jitter = 12.0, 1.0
    elif case == "heavy spill relativistic":
        tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
        vscale, jitter, rel, c = 25.0, 1.0, True, 60.0
    else:
        assert case == "repair"
        tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    rng = np.random.default_rng(22)
    pos = (rng.random((n, 2)) * np.array(shape)).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    table = torch.tensor(rng.standard_normal((*shape, 6)),
                         dtype=torch.float32, device=cuda)
    if case == "repair":
        # the spread and reserved layout after 4 steps in which rows at
        # ~0.6 cells a step left their tiles and were relocated into
        # filler slots of their new tiles
        cfg = em.EMConfig(grid_shape=shape, cell_size=(0.5, 0.5), dt=0.1,
                          charge=-0.01, mass=0.01, field_gather="centered")
        sim = em.SortedElectromagneticPIC(
            cfg, pos, 3.0 * vel / vscale, tiling=tiling,
            resort_every=10 ** 9, check_spill=False,
            gather_backend="fused", repair=True, device=cuda)
        sim.step(4)
        st = sim.state
        assert st.spill > 100, "needs relocated rows"
        v = st.valid.reshape(-1, tiling.block)
        assert bool((v[:, 1:] & ~v[:, :-1]).any()), "needs holes"
        return (table, st.position.contiguous(), st.velocity.contiguous(),
                st.valid, st.tile_id, shape, tiling, rel, c)
    pos, vel = (torch.tensor(x, device=cuda) for x in (pos, vel))
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
        derive_valid=True, cell_order=cell_order)
    if jitter:
        pos_p = torch.remainder(
            pos_p + jitter * torch.tensor(
                rng.standard_normal(tuple(pos_p.shape)), dtype=torch.float32,
                device=cuda),
            torch.tensor(shape, dtype=torch.float32, device=cuda))
    n_tiles = int(np.prod(tiling.n_tiles(shape)))
    assert int((tid == n_tiles).sum()) > 0, "needs sentinel blocks"
    return (table, pos_p.contiguous(),
            torch.stack([v0, v1, v2], -1).contiguous(), valid, tid, shape,
            tiling, rel, c)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "tile 32 margin 6", "tile 16 margin 7", "by cell", "L1 form",
    "L1 form 256", "heavy spill", "heavy spill relativistic", "repair"])
def test_fused_em2d_substep_kernel_tile_edges(cuda, case):
    """The tile-owned kernel on its edges, each of its four forms reached
    by the window: tiles of ~20 blocks split among the warps, the EM rungs'
    windows (tile 32 margin 6: 512 threads a CTA, staged; tile 16 margin
    7: 256, staged), rows by cell, windows whose fields do not fit beside J
    (77^2: 512 threads, corners through L1; 91^2: 256, through L1), heavy
    spill with span rows (also relativistic), and the repair layout with
    relocated rows and holes.  Positions, velocities and in_win bit for
    bit, J to 1e-5 of max|J|; sentinel blocks back as given with in_win
    False."""
    from fusion_sim_torch.ops import fused_em

    table, pos_p, vel_p, valid, tid, shape, tiling, rel, c = _em2d_layout(
        cuda, case)
    args = (table, pos_p, vel_p, valid, tid, shape, tiling, 0.1, 0.1,
            (0.5, 0.8), -0.01)
    nr, nz, ntz, n_tiles, k = fused_em._constants(
        shape, tiling, pos_p, 0.1, 0.1, (0.5, 0.8), -0.01, c)
    got = fused_em._launch(*args[:7], rel, nr, nz, ntz, n_tiles, k)
    plain = fused_em.fused_em2d_substep_plain(*args, c_light=c,
                                              relativistic=rel)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    sent = tid == n_tiles
    assert torch.equal(got[0][sent], pos_p[sent])
    assert torch.equal(got[1][sent], vel_p[sent])
    assert not bool(got[3][sent].any())
    if case.startswith("heavy"):
        assert int((~plain[3] & valid).sum()) > 100, "needs actual spill"
        moved = (torch.floor(got[0]) != torch.floor(pos_p)).any(-1)
        assert int((moved & got[3] & valid).sum()) > 100, "needs span rows"


@pytest.mark.cuda
def test_fused_em2d_substep_kernel_refuses_a_window_over_227_kb(cuda):
    """141^2 cells: J and the queues alone pass the 227 KB a block can
    use."""
    from fusion_sim_torch.ops import fused_em

    tiling = Tiling2D(tile_r=128, tile_z=128, block=128, margin=6)
    shape, n = (128, 256), 256
    args = (torch.zeros((*shape, 6), device=cuda),
            torch.zeros((n, 2), device=cuda),
            torch.zeros((n, 3), device=cuda),
            torch.ones((n,), dtype=torch.bool, device=cuda),
            torch.zeros((n,), dtype=torch.int32, device=cuda), shape, tiling,
            0.1, 0.1, (0.5, 0.5), -0.01)
    with pytest.raises(ValueError, match="shared memory"):
        fused_em.fused_em2d_substep(*args)


@pytest.mark.cuda
def test_pusher_kernels_reject_bad_inputs(cuda):
    from fusion_sim_torch.ops import fused_pusher, sorted_gather

    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    n = 256
    table = torch.zeros((64, 64, 13), device=cuda)
    p3 = torch.zeros((n, 3), device=cuda)
    w = torch.zeros((n,), device=cuda)
    rand = torch.zeros((n, 4), device=cuda)
    tid = torch.zeros((n,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rand"):
        fused_pusher.fused_pusher_substep(table, p3, p3, w,
                                          torch.zeros((4, n), device=cuda).t(),
                                          tid, 64, 64, tiling, 0.6)
    with pytest.raises(TypeError, match="tile_id"):
        fused_pusher.fused_pusher_substep(table, p3, p3, w, rand, tid.long(),
                                          64, 64, tiling, 0.6)
    with pytest.raises(ValueError, match="grid"):
        sorted_gather.gather_sorted_2d_window(
            torch.zeros((64, 64), device=cuda).t(), p3[:, :2].contiguous(),
            tid, (64, 64), tiling)


def _layout3d(cuda, vscale, shape, tiling, n, seed, jitter=0.0):
    """Tile-sorted 3D rows on the card: (position, velocity, valid,
    tile_id), positions optionally jittered after the sort so that some
    rows fail only the gather criterion."""
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.random((n, 3)) * np.array(shape),
                       dtype=torch.float32, device=cuda)
    vel = torch.tensor(vscale * rng.standard_normal((n, 3)),
                       dtype=torch.float32, device=cuda)
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
        derive_valid=True)
    if jitter:
        pos_p = torch.remainder(
            pos_p + jitter * torch.tensor(
                rng.standard_normal(tuple(pos_p.shape)), dtype=torch.float32,
                device=cuda),
            torch.tensor(shape, dtype=torch.float32, device=cuda))
    return (pos_p.contiguous(), torch.stack([v0, v1, v2], -1).contiguous(),
            valid, tid)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,margin,vscale,jitter", [
    ((8, 8, 8), 2, 0.5, 0.0), ((8, 8, 8), 1, 6.0, 0.0),
    ((8, 8, 16), 2, 3.0, 1.5)])   # no spill / heavy spill / big window
def test_fused_es3d_substep_kernel_matches_plain(cuda, tile, margin, vscale,
                                                 jitter):
    """Built with -fmad=false and the plain version's operation order:
    positions, velocities and in_win bit for bit; rho differs only by the
    order of its atomic sums, 1e-5 of max|rho|.  The (8, 8, 16) window
    needs 56.8 KB of shared memory (the opt-in path)."""
    from fusion_sim_torch.ops import fused_pic3d
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D

    shape = (16, 16, 32)
    tiling = Tiling3D(tile=tile, block=128, margin=margin)
    pos_p, vel_p, valid, tid = _layout3d(cuda, vscale, shape, tiling, 8192,
                                         14, jitter)
    e_grid = torch.tensor(np.random.default_rng(15).standard_normal(
        (*shape, 3)), dtype=torch.float32, device=cuda)
    w = torch.where(valid, 1.5, 0.0).to(torch.float32)
    args = (e_grid, pos_p, vel_p, w, tid, shape, tiling, 0.25, 0.5, 0.4, 0.6)
    before = fused_pic3d.LAUNCHES
    got = fused_pic3d.fused_es3d_substep(*args)
    assert fused_pic3d.LAUNCHES == before + 1
    plain = fused_pic3d.fused_es3d_substep_plain(*args)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    if vscale > 1:
        assert int((~plain[3] & valid).sum()) > 100, "needs actual spill"


def _es3d_edge_layout(cuda, margin, vscale, order, seed=20):
    """A 16 x 16 x 32 grid of 8^3 tiles (2 x 2 x 4) with block 64: tiles 0
    and 3 hold no row, tile 1 exactly one block, tile 2 twenty blocks, the
    others 30-200 rows; the trailing blocks carry the sentinel tile id.
    ``order``: 'tile' (the stable tile sort), 'cell' (each tile's rows by
    cell) or 'shuffled' (each tile's rows in a random order, fillers
    included)."""
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D

    shape = (16, 16, 32)
    tiling = Tiling3D(tile=(8, 8, 8), block=64, margin=margin)
    rng = np.random.default_rng(seed)
    counts = rng.integers(30, 200, 16)
    counts[[0, 1, 2, 3]] = (0, 64, 20 * 64, 0)
    corner = np.array([[(t // 8) * 8, (t // 4 % 2) * 8, (t % 4) * 8]
                       for t in range(16)], np.float32)
    pos = np.concatenate([corner[t] + 8 * rng.random((c, 3))
                          for t, c in enumerate(counts)]).astype(np.float32)
    n = -(-pos.shape[0] // 64) * 64
    pos = np.concatenate([pos, corner[15] + 8 * rng.random(
        (n - pos.shape[0], 3))])
    vel = vscale * rng.standard_normal((n, 3))
    pos, vel = (torch.tensor(x, dtype=torch.float32, device=cuda)
                for x in (pos, vel))
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
        derive_valid=True, cell_order=order != "tile")
    vel_p = torch.stack([v0, v1, v2], -1)
    if order == "shuffled":
        key = tid.long() * 2 ** 32 + torch.randint(
            0, 2 ** 31, tid.shape, device=cuda, generator=torch.Generator(
                device=cuda).manual_seed(seed))
        perm = torch.argsort(key)
        pos_p, vel_p, valid = pos_p[perm], vel_p[perm], valid[perm]
    seg = torch.bincount(tid.long(), minlength=17).tolist()
    assert seg[0] == seg[3] == 0 and seg[1] == 64 and seg[2] >= 20 * 64
    assert seg[16] > 0, "needs sentinel blocks"
    return shape, tiling, pos_p.contiguous(), vel_p.contiguous(), valid, tid


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["tile", "cell", "shuffled"])
@pytest.mark.parametrize("margin,vscale", [(2, 0.3), (1, 6.0), (6, 0.3),
                                           (7, 2.0)])
def test_fused_es3d_substep_kernel_tile_edges(cuda, order, margin, vscale):
    """The tile-owned kernel's edges: empty tiles, a tile of one block, a
    tile of twenty, sentinel blocks (back as given, in_win False), rows by
    tile, by cell and shuffled inside each tile (the warp-combined deposit
    must not depend on the order), heavy spill at margin 1, and the largest
    windows: margin 6 (21^3 cells, 148 KB of shared memory) and margin 7
    (23^3, 195 KB, the largest B5 window of 8^3 tiles).  Positions,
    velocities and in_win bit for bit; rho to 1e-5 of max|rho|."""
    from fusion_sim_torch.ops import fused_pic3d

    shape, tiling, pos_p, vel_p, valid, tid = _es3d_edge_layout(
        cuda, margin, vscale, order)
    e_grid = torch.tensor(np.random.default_rng(21).standard_normal(
        (*shape, 3)), dtype=torch.float32, device=cuda)
    w = torch.where(valid, 1.5, 0.0).to(torch.float32)
    args = (e_grid, pos_p, vel_p, w, tid, shape, tiling, 0.25, 0.5, 0.4, 0.6)
    got = fused_pic3d.fused_es3d_substep(*args)
    plain = fused_pic3d.fused_es3d_substep_plain(*args)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    sent = tid == 16
    assert torch.equal(got[0][sent], pos_p[sent])
    assert torch.equal(got[1][sent], vel_p[sent])
    assert not bool(got[3][sent].any())
    if margin == 1:
        assert int((~plain[3] & valid).sum()) > 100, "needs actual spill"


@pytest.mark.cuda
@pytest.mark.parametrize("margin,vscale,jitter,relativistic,c_light", [
    (2, 0.3, 0.0, False, 1.0), (2, 1.5, 0.0, True, 1.0),
    (1, 12.0, 1.0, False, 1.0), (2, 25.0, 1.0, True, 60.0)])
def test_fused_em3d_substep_kernel_matches_plain(cuda, margin, vscale, jitter,
                                                 relativistic, c_light):
    """Positions, velocities and in_win bit for bit; J differs only by the
    order of its atomic sums, 1e-5 of max|J|."""
    from fusion_sim_torch.ops import fused_em3d
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D

    shape = (16, 16, 32)
    tiling = Tiling3D(tile=(8, 8, 8), block=128, margin=margin)
    pos_p, vel_p, valid, tid = _layout3d(cuda, vscale, shape, tiling, 8192,
                                         16, jitter)
    table = torch.tensor(np.random.default_rng(17).standard_normal(
        (*shape, 6)), dtype=torch.float32, device=cuda)
    args = (table, pos_p, vel_p, valid, tid, shape, tiling, 0.1, 0.1,
            (0.5, 0.8, 0.6), -0.01)
    kw = dict(c_light=c_light, relativistic=relativistic)
    before = fused_em3d.LAUNCHES
    got = fused_em3d.fused_em3d_substep(*args, **kw)
    assert fused_em3d.LAUNCHES == before + 1
    plain = fused_em3d.fused_em3d_substep_plain(*args, **kw)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    if vscale > 10:
        assert int((~plain[3] & valid).sum()) > 100, "needs actual spill"


@pytest.mark.cuda
@pytest.mark.parametrize("margin,block,vscale,relativistic,c_light", [
    (2, 64, 0.3, False, 1.0), (2, 64, 2.0, True, 60.0),
    (7, 128, 0.3, False, 1.0)])
def test_fused_em3d_substep_kernel_pipeline_edges(cuda, margin, block, vscale,
                                                  relativistic, c_light):
    """The edges of the tile-owned kernel: every tile of a 16 x 16 x 32 grid
    wraps its window at the periodic edge; the particles fill only x < 8,
    so half the tiles are empty; a tile's ~16 blocks outrun one pass of
    the CTA's threads; rows faster than a cell go through the warps'
    queues; the sentinel blocks come back as given with in_win False; and
    margin 7 (a 23^3 window) takes the form that reads the corners
    through L1.  Positions, velocities and in_win bit for bit, J to 1e-5
    of max|J|."""
    from fusion_sim_torch.ops import fused_em3d
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D

    shape = (16, 16, 32)
    tiling = Tiling3D(tile=(8, 8, 8), block=block, margin=margin)
    rng = np.random.default_rng(19)
    pos = torch.tensor(rng.random((8192, 3)) * np.array([8, 16, 32]),
                       dtype=torch.float32, device=cuda)
    vel = torch.tensor(vscale * rng.standard_normal((8192, 3)),
                       dtype=torch.float32, device=cuda)
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
        derive_valid=True)
    vel_p = torch.stack([v0, v1, v2], -1).contiguous()
    n_tiles = 2 * 2 * 4
    assert int((tid == n_tiles).sum()) > 0, "needs sentinel blocks"
    table = torch.tensor(rng.standard_normal((*shape, 6)),
                         dtype=torch.float32, device=cuda)
    args = (table, pos_p.contiguous(), vel_p, valid, tid, shape, tiling, 0.1,
            0.1, (0.5, 0.8, 0.6), -0.01)
    kw = dict(c_light=c_light, relativistic=relativistic)
    got = fused_em3d.fused_em3d_substep(*args, **kw)
    plain = fused_em3d.fused_em3d_substep_plain(*args, **kw)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    sent = tid == n_tiles
    assert torch.equal(got[0][sent], pos_p[sent])
    assert torch.equal(got[1][sent], vel_p[sent])
    assert not bool(got[3][sent].any())
    if vscale > 1:
        moved = (torch.floor(got[0]) != torch.floor(pos_p)).any(-1)
        assert int((moved & got[3] & valid).sum()) > 100, "needs fast rows"


@pytest.mark.cuda
def test_3d_kernels_reject_bad_inputs(cuda):
    from fusion_sim_torch.ops import fused_em3d, fused_pic3d
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D

    shape = (16, 16, 32)
    tiling = Tiling3D(tile=(8, 8, 8), block=128, margin=2)
    pos_p, vel_p, valid, tid = _layout3d(cuda, 0.1, shape, tiling, 256, 18)
    table = torch.zeros((*shape, 6), device=cuda)
    args = [table, pos_p, vel_p, valid, tid]
    for i, name, bad, exc in (
            (0, "table", table.cpu(), ValueError),
            (1, "position", pos_p[:, :2].contiguous(), ValueError),
            (2, "velocity", vel_p.t().contiguous().t(), ValueError),
            (3, "valid", valid.float(), TypeError),
            (4, "tile_id", tid.long(), TypeError)):
        broken = list(args)
        broken[i] = bad
        with pytest.raises(exc, match=name):
            fused_em3d.fused_em3d_substep(*broken, shape, tiling, 0.1, 0.1,
                                          (0.5, 0.5, 0.5), -0.01)
    w = valid.float()
    with pytest.raises(ValueError, match="e_grid"):
        fused_pic3d.fused_es3d_substep(table, pos_p, vel_p, w, tid, shape,
                                       tiling, 0.1, 0.1, 0.1, 0.1)
    # a window that cannot fit in a block's shared memory is refused
    big = Tiling3D(tile=(16, 16, 32), block=128, margin=7)
    with pytest.raises(ValueError, match="shared memory"):
        fused_pic3d.fused_es3d_substep(table[..., :3].contiguous(), pos_p,
                                       vel_p, w, tid, shape, big, 0.1, 0.1,
                                       0.1, 0.1)
    # a refused B5 window: 23 x 23 x 31 cells need 262 KB
    over = Tiling3D(tile=(8, 8, 16), block=128, margin=7)
    with pytest.raises(ValueError, match="shared memory"):
        fused_pic3d.fused_es3d_substep(table[..., :3].contiguous(), pos_p,
                                       vel_p, w, tid, shape, over, 0.1, 0.1,
                                       0.1, 0.1)
    with pytest.raises(ValueError, match="shared memory"):
        fused_em3d.fused_em3d_substep(*args, shape, big, 0.1, 0.1,
                                      (0.5, 0.5, 0.5), -0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [24, 32, 48, 96, 128])
@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("order", ["lhs_k_lanes", "lhs_k_sublanes"])
def test_contraction_depth_kernel_matches_plain(cuda, order, precision, k):
    """X1 on the tensor cores against its plain version (bf16-rounded for
    'default'), at m = 96 (6 row tiles) and p = 320 (a ragged last column
    chunk): 1e-5 of sum |a||b| per output for 'highest' (3xTF32), 1e-4 for
    'default' (bf16 products exact, f32 sums in another order)."""
    from fusion_sim_torch.ops import contraction_depth as cd

    s, g, m, p = 5, 3, 96, 320
    gen = torch.Generator(device=cuda).manual_seed(k)
    a_shape = (s, g, m, k) if order == "lhs_k_lanes" else (s, g, k, m)
    a = torch.randn(a_shape, generator=gen, device=cuda)
    b = torch.randn((s, g, k, p), generator=gen, device=cuda)
    before = cd.LAUNCHES
    got = cd.contraction_depth(a, b, order, precision)
    assert cd.LAUNCHES == before + 1
    plain = cd.contraction_depth_plain(a, b, order, precision)
    torch.cuda.synchronize()
    scale = cd.contraction_depth_plain(a.abs(), b.abs(), order, "highest")
    tol = 1e-5 if precision == "highest" else 1e-4
    assert got.shape == (s, 1, p)
    assert bool(((got - plain).abs() <= tol * scale).all())
    # deterministic: no atomics
    assert torch.equal(got, cd.contraction_depth(a, b, order, precision))


@pytest.mark.cuda
@pytest.mark.parametrize("s,g,m,k,p", [
    (3, 1, 96, 8, 128), (2, 1, 20, 40, 196), (4, 5, 36, 136, 100)])
@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("order", ["lhs_k_lanes", "lhs_k_sublanes"])
def test_contraction_depth_kernel_pipeline_edges(cuda, order, precision, s, g,
                                                 m, k, p):
    """The ring's edges: G = 1 with a single stage (the prologue runs past
    the last stage), G = 1 and odd G = 5 with K not a multiple of the
    stage depth 16 (the depth rows beyond K copied as zeros), m not a
    multiple of 16 and p not a multiple of 128.  Tolerances as above."""
    from fusion_sim_torch.ops import contraction_depth as cd

    gen = torch.Generator(device=cuda).manual_seed(k + g)
    a_shape = (s, g, m, k) if order == "lhs_k_lanes" else (s, g, k, m)
    a = torch.randn(a_shape, generator=gen, device=cuda)
    b = torch.randn((s, g, k, p), generator=gen, device=cuda)
    got = cd.contraction_depth(a, b, order, precision)
    plain = cd.contraction_depth_plain(a, b, order, precision)
    scale = cd.contraction_depth_plain(a.abs(), b.abs(), order, "highest")
    tol = 1e-5 if precision == "highest" else 1e-4
    assert got.shape == (s, 1, p)
    assert bool(((got - plain).abs() <= tol * scale).all())


@pytest.mark.cuda
def test_contraction_depth_kernel_rejects_bad_inputs(cuda):
    from fusion_sim_torch.ops import contraction_depth as cd

    a = torch.zeros((2, 2, 16, 24), device=cuda)
    b = torch.zeros((2, 2, 24, 128), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        cd.contraction_depth(a.double(), b, "lhs_k_lanes", "highest")
    with pytest.raises(ValueError, match="contiguous"):
        cd.contraction_depth(a, b.transpose(2, 3).contiguous()
                             .transpose(2, 3), "lhs_k_lanes", "highest")
    with pytest.raises(ValueError, match="multiples of 4"):
        cd.contraction_depth(a, torch.zeros((2, 2, 24, 130), device=cuda),
                             "lhs_k_lanes", "highest")
    # the ring holds m16 rows of A a stage: m = 1024 needs ~298 KB
    with pytest.raises(ValueError, match="shared memory"):
        cd.contraction_depth(torch.zeros((1, 1, 1024, 128), device=cuda),
                             torch.zeros((1, 1, 128, 128), device=cuda),
                             "lhs_k_lanes", "highest")
