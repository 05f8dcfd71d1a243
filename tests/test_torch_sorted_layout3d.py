"""Port vs reference: the tile-sorted 3D layout and the plain 3D transfers
on it (fusion_sim_torch/ops/sorted_deposit.py, ops/esirkepov.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import sorted_deposit as tp
from fusion_sim_torch.ops.esirkepov import esirkepov_deposit_3d
from fusion_sim_torch.ops.interp import cic_deposit
from fusion_sim_tpu.ops import esirkepov as jes
from fusion_sim_tpu.ops import sorted_deposit as jx
from fusion_sim_tpu.ops.pallas_pic3d import _local_coords_3d
from torch_ranks import one_torch_thread  # noqa: F401

SHAPE = (16, 16, 32)
TILE = dict(tile=(8, 8, 16), block=128, margin=2)   # tests/test_sorted_deposit
CELL = (0.9, 1.1, 0.7)
DT = 0.3


def _particles(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.array(SHAPE)).astype(np.float32)
    pos[:3] = np.array(SHAPE, np.float32)   # mod edge: clipped to last tile
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return pos, vel, valid


def _segments(tid, rows):
    """tile -> sorted list of row tuples (the order inside a tile is the
    sort's business; the reference's sort does not promise one)."""
    return {int(t): sorted(map(tuple, rows[tid == t].tolist()))
            for t in np.unique(tid)}


@pytest.mark.parametrize("with_valid", [False, True])
def test_build_padded_layout_3d_matches_reference(with_valid):
    pos, vel, valid = _particles()
    jt, tt = jx.Tiling3D(**TILE), tp.Tiling3D(**TILE)
    np.testing.assert_array_equal(
        tp.tile_ids_3d(torch.tensor(pos), SHAPE, tt).numpy(),
        np.asarray(jx.tile_ids_3d(jnp.asarray(pos), SHAPE, jt)))
    kw_j = dict(valid=jnp.asarray(valid)) if with_valid else {}
    kw_t = dict(valid=torch.tensor(valid)) if with_valid else {}
    outj = jx.build_padded_layout(
        jnp.asarray(pos), SHAPE, jt, *[jnp.asarray(vel[:, a])
                                       for a in range(3)],
        derive_valid=True, **kw_j)
    outt = tp.build_padded_layout(
        torch.tensor(pos), SHAPE, tt, *[torch.tensor(vel[:, a])
                                        for a in range(3)],
        derive_valid=True, **kw_t)
    tid_j, tid_t = np.asarray(outj[0]), outt[0].numpy()
    # tile ids, validity and the real+filler count are exact
    np.testing.assert_array_equal(tid_t, tid_j)
    np.testing.assert_array_equal(outt[5].numpy(), np.asarray(outj[5]))
    assert int(outt[6]) == int(outj[6])
    assert outt[0].dtype == torch.int32 and outt[1].shape[1] == 3
    assert tid_t.shape[0] == pos.shape[0] + 2 * 2 * 2 * TILE["block"]
    # each tile segment holds the same rows (position, payloads, validity)
    rows_j = np.column_stack([np.asarray(o) for o in outj[1:6]])
    rows_t = np.column_stack([o.numpy() for o in outt[1:6]])
    assert _segments(tid_t, rows_t) == _segments(tid_j, rows_j)
    # every block lies in one tile
    blocks = tid_t.reshape(-1, TILE["block"])
    assert (blocks == blocks[:, :1]).all()
    # window origins and window-local coordinates as the reference's kernels
    # take them (z fastest in the tile index)
    _, origins_j, locals_j = _local_coords_3d(outj[1], outj[0], SHAPE, jt,
                                              TILE["block"])
    origins_t = tp.window_origins_3d(outt[0], SHAPE, tt)
    real = tid_t[::TILE["block"]] < 8
    for a in range(3):
        np.testing.assert_array_equal(origins_t[a].numpy()[real],
                                      np.asarray(origins_j[a])[real])
        # the sentinel's origin differs by a whole grid: the same frame
        np.testing.assert_array_equal(
            np.mod(origins_t[a].numpy(), SHAPE[a]),
            np.mod(np.asarray(origins_j[a]), SHAPE[a]))
    from fusion_sim_torch.ops.fused_pic3d import local_frame_3d
    loc_t = local_frame_3d(torch.tensor(np.asarray(outj[1])), outt[0], SHAPE,
                           tt, 8)[3]
    rows = np.repeat(real, TILE["block"])
    for a in range(3):
        np.testing.assert_array_equal(
            loc_t[a].numpy()[rows], np.asarray(locals_j[a]).reshape(-1)[rows])


@pytest.mark.parametrize("with_valid,reserve", [(False, False),
                                                (True, False), (True, True)])
def test_build_padded_layout_3d_by_cell_matches_reference(with_valid,
                                                          reserve):
    """``cell_order=True`` (the ES 3D shell's layout): the reference's tile
    ids, validity and padding exactly, each tile segment the same rows as a
    set, and inside each segment the real rows in the order of their cell
    inside the tile (z fastest; computed here with numpy), fillers last."""
    pos, vel, valid = _particles(seed=1)
    jt, tt = jx.Tiling3D(**TILE), tp.Tiling3D(**TILE)
    kw_j = dict(valid=jnp.asarray(valid)) if with_valid else {}
    kw_t = dict(valid=torch.tensor(valid)) if with_valid else {}
    outj = jx.build_padded_layout(
        jnp.asarray(pos), SHAPE, jt, *[jnp.asarray(vel[:, a])
                                       for a in range(3)],
        derive_valid=True, reserve=reserve, spread=reserve, **kw_j)
    outt = tp.build_padded_layout(
        torch.tensor(pos), SHAPE, tt, *[torch.tensor(vel[:, a])
                                        for a in range(3)],
        derive_valid=True, reserve=reserve, spread=reserve, cell_order=True,
        **kw_t)
    tid_j, tid_t = np.asarray(outj[0]), outt[0].numpy()
    np.testing.assert_array_equal(tid_t, tid_j)
    np.testing.assert_array_equal(outt[5].numpy(), np.asarray(outj[5]))
    assert int(outt[6]) == int(outj[6])
    assert outt[0].dtype == torch.int32
    rows_j = np.column_stack([np.asarray(o) for o in outj[1:6]])
    rows_t = np.column_stack([o.numpy() for o in outt[1:6]])
    assert _segments(tid_t, rows_t) == _segments(tid_j, rows_j)
    # the cell inside the tile, from the base cell clamped into the grid
    base = np.clip(np.floor(outt[1].numpy()).astype(np.int64), 0,
                   np.array(SHAPE) - 1)
    tile = np.array(TILE["tile"])
    local = base % tile
    cell = (local[:, 0] * tile[1] + local[:, 1]) * tile[2] + local[:, 2]
    real = outt[5].numpy()
    np.testing.assert_array_equal(
        tp.tile_cell_keys(outt[1], SHAPE, tt).numpy()[real],
        (tid_t.astype(np.int64) * tile.prod() + cell)[real])
    for t in np.unique(tid_t[tid_t < 8]):
        seg = np.flatnonzero(tid_t == t)
        r = real[seg]
        assert not (r[1:] & ~r[:-1]).any(), "fillers after the real rows"
        assert (np.diff(cell[seg][r]) >= 0).all(), f"tile {t} not by cell"
    # without cell_order the layout is the tile sort as before
    plain = tp.build_padded_layout(
        torch.tensor(pos), SHAPE, tt, *[torch.tensor(vel[:, a])
                                        for a in range(3)],
        derive_valid=True, reserve=reserve, spread=reserve, **kw_t)
    np.testing.assert_array_equal(plain[0].numpy(), tid_t)
    assert not np.array_equal(plain[1].numpy(), outt[1].numpy())


def test_tiling3d_validation():
    with pytest.raises(ValueError, match="margin"):
        tp.Tiling3D(tile=(8, 4, 8), margin=4)
    with pytest.raises(ValueError, match="divisible"):
        tp.Tiling3D(**TILE).n_tiles((16, 16, 24))
    assert tp.Tiling3D(**TILE).n_tiles(SHAPE) == (2, 2, 2)
    assert tp.Tiling3D(**TILE).window() == (13, 13, 21)
    assert tp.Tiling3D() == tp.Tiling3D((8, 8, 8), 512, 1, "float32")
    pos = torch.zeros((128, 3))
    # spread is ported (tests/test_torch_repair.py): the surplus dead blocks
    # go to the tile segments, none is left trailing
    tid = tp.build_padded_layout(pos, SHAPE, tp.Tiling3D(**TILE),
                                 spread=True)[0]
    assert not bool((tid == 8).any())
    with pytest.raises(ValueError, match="multiple"):
        tp.build_padded_layout(pos[:100], SHAPE, tp.Tiling3D(**TILE))


@pytest.mark.parametrize("cell_order", [False, True])
@pytest.mark.parametrize("reserve", [False, True])
def test_layout_whole_payload_on_the_plain_path(reserve, cell_order):
    """CPU tensors take the plain sort, by tile and by cell, and never
    reach the bucket kernel (rows by cell on the card no longer take the
    sort: the kernel and its cell pass build them); an (N, 3) payload
    comes back as the same rows as its three columns."""
    from fusion_sim_torch.ops import tile_bucket
    pos, vel, valid = _particles(seed=5)
    pos[valid == 0] = 1e4     # invalid rows keep whatever they carry
    pos_t, vel_t = torch.tensor(pos), torch.tensor(vel)
    kw = dict(valid=torch.tensor(valid), reserve=reserve, spread=reserve,
              derive_valid=True, cell_order=cell_order)
    tt = tp.Tiling3D(**TILE)
    before = tile_bucket.LAUNCHES
    whole = tp.build_padded_layout(pos_t, SHAPE, tt, vel_t, **kw)
    cols = tp.build_padded_layout(pos_t, SHAPE, tt, *vel_t.unbind(-1), **kw)
    assert tile_bucket.LAUNCHES == before
    assert whole[2].shape == (pos.shape[0] + 8 * TILE["block"], 3)
    assert torch.equal(whole[2], torch.stack(cols[2:5], -1))
    for a, b in zip(whole[:2] + whole[3:], cols[:2] + cols[5:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,n_keys", [(0, 9), (1024, 9), (200_064, 33),
                                      (10_262_528, 257),
                                      (424_319_488, 4097), (65_536, 16_385)])
def test_tile_bucket_chunking(n, n_keys):
    """The kernel's chunks: every row in one, none empty, at most
    MAX_CHUNKS of them, and a count matrix of at most 2 B a row beside
    the keys' own arrays."""
    from fusion_sim_torch.ops import tile_bucket
    chunk, n_chunks = tile_bucket.chunking(n, n_keys)
    assert chunk >= 1
    assert (n_chunks - 1) * chunk < max(n, 1) <= n_chunks * chunk
    assert n_chunks <= tile_bucket.MAX_CHUNKS
    assert 4 * n_keys * (n_chunks + 1) <= 2 * n + 8 * n_keys


def _drifted_layout(seed, shift):
    """The reference's layout of random rows, then every third real row
    moved ``shift`` cells along y (past the margin), so those rows spill."""
    pos, _, _ = _particles(seed=seed)
    jt = jx.Tiling3D(**TILE)
    tid, pos_p, validp, _ = jx.build_padded_layout(
        jnp.asarray(pos), SHAPE, jt, jnp.ones((pos.shape[0],), jnp.float32))
    pos_p, real = np.array(pos_p), np.asarray(validp) > 0.5
    moved = np.flatnonzero(real)[::3]
    pos_p[moved, 1] = np.mod(pos_p[moved, 1] + shift, SHAPE[1])
    return pos_p, np.asarray(tid), real, moved


@pytest.mark.parametrize("mode", ["cic", "nearest"])
def test_gather_sorted_3d_matches_reference(mode):
    """tests/test_sorted_deposit.py:289 with out-of-window rows added: the
    same in_win, the same clamped-window values."""
    pos_p, tid, real, moved = _drifted_layout(3, 7.0)
    grid = np.random.default_rng(4).standard_normal((*SHAPE, 6)).astype(
        np.float32)
    v_j, w_j = jx.gather_sorted_3d(jnp.asarray(grid), jnp.asarray(pos_p),
                                   jnp.asarray(tid), SHAPE,
                                   jx.Tiling3D(**TILE), mode=mode)
    v_t, w_t = tp.gather_sorted_3d(torch.tensor(grid), torch.tensor(pos_p),
                                   torch.tensor(tid), SHAPE,
                                   tp.Tiling3D(**TILE), mode=mode)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert 0 < (~w_t.numpy() & real).sum() <= len(moved)
    # the same window cells and weights; the reference sums them with f32
    # matmuls: 1e-6 relative (2e-6 absolute near 0)
    np.testing.assert_allclose(v_t.numpy()[real], np.asarray(v_j)[real],
                               rtol=1e-6, atol=2e-6)
    # a scalar grid comes back without a channel axis
    v1, _ = tp.gather_sorted_3d(torch.tensor(grid[..., 0]),
                                torch.tensor(pos_p), torch.tensor(tid),
                                SHAPE, tp.Tiling3D(**TILE), mode=mode)
    np.testing.assert_array_equal(v1.numpy(), v_t.numpy()[:, 0])
    with pytest.raises(ValueError, match="mode"):
        tp.gather_sorted_3d(torch.tensor(grid), torch.tensor(pos_p),
                            torch.tensor(tid), SHAPE, tp.Tiling3D(**TILE),
                            mode="linear")


def test_deposit_sorted_3d_matches_reference():
    pos_p, tid, real, moved = _drifted_layout(5, 7.0)
    w = np.where(real, 1.25, 0.0).astype(np.float32)
    g_j, s_j, m_j = jx.deposit_sorted_3d(jnp.asarray(pos_p), jnp.asarray(w),
                                         jnp.asarray(tid), SHAPE,
                                         jx.Tiling3D(**TILE))
    g_t, s_t, m_t = tp.deposit_sorted_3d(torch.tensor(pos_p),
                                         torch.tensor(w), torch.tensor(tid),
                                         SHAPE, tp.Tiling3D(**TILE))
    assert int(s_t) == int(s_j) > 0
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    # same CIC weights; the reference sums per block with f32 matmuls, the
    # port scatters per row: 1e-5 of max|rho|
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=1e-5 * float(np.abs(g_j).max()))


def _motion(n, seed, reach=0.9):
    """tests/test_sorted_deposit.py's inputs: moves under a cell per axis."""
    rng = np.random.default_rng(seed)
    x0 = rng.random((n, 3)).astype(np.float32) * np.array(SHAPE, np.float32)
    x1 = x0 + ((rng.random((n, 3)) - 0.5) * reach).astype(np.float32)
    return x0, x1


def _continuity_residual(j, x0, x1, w):
    """(rho1 - rho0)/dt + div_Yee J on the port's own output."""
    sh = torch.tensor(SHAPE, dtype=torch.float32)
    rho0 = cic_deposit(torch.remainder(x0, sh), w, SHAPE)
    rho1 = cic_deposit(torch.remainder(x1, sh), w, SHAPE)
    div = sum((j[..., a] - torch.roll(j[..., a], 1, a)) / CELL[a]
              for a in range(3))
    return float(((rho1 - rho0) / DT + div).abs().max()), float(
        rho0.abs().max())


@pytest.mark.parametrize("per_particle_charge", [False, True])
def test_esirkepov_deposit_3d_matches_reference(per_particle_charge):
    n = 2048
    x0, x1 = _motion(n, 11)
    q = (np.where(np.arange(n) % 3 == 0, 0.0, -1.3).astype(np.float32)
         if per_particle_charge else -1.3)
    ref = np.asarray(jes.esirkepov_deposit_3d(
        jnp.asarray(x0), jnp.asarray(x1),
        jnp.asarray(q) if per_particle_charge else q, DT, SHAPE, CELL))
    got = esirkepov_deposit_3d(
        torch.tensor(x0), torch.tensor(x1),
        torch.tensor(q) if per_particle_charge else q, DT, SHAPE, CELL)
    assert got.shape == (*SHAPE, 3)
    # the same per-particle f32 factors; the grid sums run in another order
    # (one scatter row of 81 channels plus rolls against index_add_ on the
    # 27 nodes): 1e-6 of max|J|
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max(), rtol=0)
    # charge continuity (tests/test_electromagnetic.py:80, in 3D)
    w = torch.as_tensor(q, dtype=torch.float32).expand(n) / float(
        np.prod(CELL))
    res, scale = _continuity_residual(got, torch.tensor(x0),
                                      torch.tensor(x1), w)
    assert res < 5e-5 * max(scale / DT, 1.0)


def test_esirkepov_deposit_3d_passes_are_one_sum(monkeypatch):
    """Rows are processed a bounded number at a time; the passes add up to
    the same current."""
    from fusion_sim_torch.ops import esirkepov
    x0, x1 = _motion(1000, 12)
    whole = esirkepov_deposit_3d(torch.tensor(x0), torch.tensor(x1), -1.3,
                                 DT, SHAPE, CELL)
    monkeypatch.setattr(esirkepov, "_ROWS_3D", 300)
    parts = esirkepov.esirkepov_deposit_3d(torch.tensor(x0),
                                           torch.tensor(x1), -1.3, DT,
                                           SHAPE, CELL)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6 * float(whole.abs().max()))


@pytest.mark.parametrize("push_out", [0, 200])
def test_esirkepov_sorted_3d_matches_reference(push_out):
    """tests/test_sorted_deposit.py:150, and with rows moved past the
    margin (x0 and x1 alike) so that they spill."""
    n = 2048
    x0, x1 = _motion(n, 13)
    qw = np.full(n, -1.3, np.float32)
    jt, tt = jx.Tiling3D(**TILE), tp.Tiling3D(**TILE)
    tid, x0_s, a, b, c, qw_s, _ = jx.build_padded_layout(
        jnp.asarray(x0), SHAPE, jt, *[jnp.asarray(x1[:, k])
                                      for k in range(3)], jnp.asarray(qw))
    x0_s = np.array(x0_s)
    x1_s = np.stack([np.asarray(a), np.asarray(b), np.asarray(c)], -1)
    real = np.flatnonzero(np.asarray(qw_s) != 0)
    moved = real[::max(len(real) // push_out, 1)][:push_out] if push_out \
        else real[:0]
    shift = np.array([0.0, TILE["tile"][1] / 2 + TILE["margin"] + 3, 0.0],
                     np.float32)
    x0_s[moved] += shift
    x1_s[moved] += shift
    arrays = [np.asarray(v) for v in (x0_s, x1_s, qw_s, tid)]
    j_r, spill_r, mask_r = jx.esirkepov_sorted_3d(
        *map(jnp.asarray, arrays), DT, SHAPE, CELL, jt)
    j_t, spill_t, mask_t = tp.esirkepov_sorted_3d(
        *map(torch.tensor, arrays), DT, SHAPE, CELL, tt)
    assert int(spill_t) == int(spill_r)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_r))
    if push_out:
        assert 0 < int(spill_t) <= push_out
        assert mask_t.numpy()[moved].sum() == int(spill_t)
    else:
        assert int(spill_t) == 0
    j_r = np.asarray(j_r)
    # the reference's 'highest' f32 one-hot matmuls per block against
    # index_add_ on the 27 stencil nodes: summation order, 3e-6 of max|J|
    np.testing.assert_allclose(j_t.numpy(), j_r,
                               atol=3e-6 * np.abs(j_r).max(), rtol=0)
    # the spilled rows' current, added by the exact deposit, restores
    # continuity for the whole set (the model's deposit patch)
    x0_t, x1_t, q_t = map(torch.tensor, arrays[:3])
    j_all = j_t + esirkepov_deposit_3d(x0_t[mask_t], x1_t[mask_t],
                                       q_t[mask_t], DT, SHAPE, CELL)
    res, scale = _continuity_residual(j_all, x0_t, x1_t,
                                      q_t / float(np.prod(CELL)))
    assert res < 5e-5 * max(scale / DT, 1.0)
