"""Port vs reference: the tile-sorted 2D layout
(fusion_sim_torch/ops/sorted_deposit.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import sorted_deposit as tp
from fusion_sim_tpu.ops import sorted_deposit as jx

SHAPE = (64, 96)
TILE = dict(tile_r=16, tile_z=16, block=128, margin=2)


def _particles(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 2)) * np.array(SHAPE)).astype(np.float32)
    pos[:3] = np.array(SHAPE, np.float32)   # mod edge: clipped to last tile
    vel = rng.standard_normal((n, 2)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return pos, vel, valid


def _segments(tid, rows):
    """tile -> sorted list of row tuples (the order inside a tile is the
    sort's business; the reference's sort does not promise one)."""
    out = {}
    for t in np.unique(tid):
        seg = rows[tid == t]
        out[int(t)] = sorted(map(tuple, seg.tolist()))
    return out


@pytest.mark.parametrize("with_valid", [False, True])
def test_build_padded_layout_matches_reference(with_valid):
    pos, vel, valid = _particles()
    jt, tt = jx.Tiling2D(**TILE), tp.Tiling2D(**TILE)
    kw_j = dict(valid=jnp.asarray(valid)) if with_valid else {}
    kw_t = dict(valid=torch.tensor(valid)) if with_valid else {}
    outj = jx.build_padded_layout(
        jnp.asarray(pos), SHAPE, jt, jnp.asarray(vel[:, 0]),
        jnp.asarray(vel), derive_valid=True, **kw_j)
    outt = tp.build_padded_layout(
        torch.tensor(pos), SHAPE, tt, torch.tensor(vel[:, 0]),
        torch.tensor(vel), derive_valid=True, **kw_t)
    tid_j, tid_t = np.asarray(outj[0]), outt[0].numpy()
    # tile ids, validity and the real+filler count are exact
    np.testing.assert_array_equal(tid_t, tid_j)
    np.testing.assert_array_equal(outt[4].numpy(), np.asarray(outj[4]))
    assert int(outt[5]) == int(outj[5])
    assert outt[0].dtype == torch.int32
    # each tile segment holds the same rows (position, payloads, validity)
    rows_j = np.column_stack([np.asarray(outj[1]), np.asarray(outj[2]),
                              np.asarray(outj[3]), np.asarray(outj[4])])
    rows_t = np.column_stack([outt[1].numpy(), outt[2].numpy(),
                              outt[3].numpy(), outt[4].numpy()])
    assert _segments(tid_t, rows_t) == _segments(tid_j, rows_j)
    # every block lies in one tile
    blocks = tid_t.reshape(-1, TILE["block"])
    assert (blocks == blocks[:, :1]).all()


def test_tiling_and_layout_validation():
    with pytest.raises(ValueError, match="margin"):
        tp.Tiling2D(tile_r=4, tile_z=16, margin=4)
    with pytest.raises(ValueError, match="divisible"):
        tp.Tiling2D(**TILE).n_tiles((60, 96))
    pos = torch.zeros((128, 2))
    # reserve/spread are ported (tests/test_torch_repair.py): every tile
    # keeps a dead slot, the layout's length is unchanged
    tid, _, valid, _ = tp.build_padded_layout(
        pos, SHAPE, tp.Tiling2D(**TILE), reserve=True, derive_valid=True)
    n_tiles = int(np.prod(tp.Tiling2D(**TILE).n_tiles(SHAPE)))
    assert tid.shape == (128 + n_tiles * TILE["block"],)
    assert all(bool((~valid[tid == t]).any()) for t in range(n_tiles))
    with pytest.raises(ValueError, match="multiple"):
        tp.build_padded_layout(pos[:100], SHAPE, tp.Tiling2D(**TILE))
    # a 3D grid with a Tiling3D is laid out too (it raised before the 3D
    # slice); reserve/spread still wait there
    out = tp.build_padded_layout(torch.zeros((128, 3)), (16, 16, 16),
                                 tp.Tiling3D((8, 8, 8), 128, 1))
    assert out[1].shape == (128 + 8 * 128, 3)
    out = tp.build_padded_layout(torch.zeros((128, 3)), (16, 16, 16),
                                 tp.Tiling3D((8, 8, 8), 128, 1), reserve=True,
                                 spread=True)
    assert out[1].shape == (128 + 8 * 128, 3) and int(out[-1]) == 128 + 8 * 128
    np.testing.assert_array_equal(
        tp.tile_ids(torch.tensor(_particles()[0]), SHAPE,
                    tp.Tiling2D(**TILE)).numpy(),
        np.asarray(jx.tile_ids(jnp.asarray(_particles()[0]), SHAPE,
                               jx.Tiling2D(**TILE))))


def test_tile_window_extract_and_fold_match_reference():
    rng = np.random.default_rng(1)
    jt, tt = jx.Tiling2D(**TILE), tp.Tiling2D(**TILE)
    wr, wz = tt.window()
    grid = rng.standard_normal((*SHAPE, 2)).astype(np.float32)
    win_j = np.asarray(jx.extract_tile_windows(jnp.asarray(grid), SHAPE, jt,
                                               wr, wz))
    win_t = tp.extract_tile_windows(torch.tensor(grid), SHAPE, tt, wr, wz)
    # pure data movement: exact
    np.testing.assert_array_equal(win_t.numpy(), win_j)
    tw = rng.standard_normal((win_j.shape[0] * win_j.shape[1], wr, wz)
                             ).astype(np.float32)
    fold_j = np.asarray(jx.fold_tile_windows(jnp.asarray(tw), SHAPE, jt, wr,
                                             wz))
    fold_t = tp.fold_tile_windows(torch.tensor(tw), SHAPE, tt, wr, wz)
    # up to 4 overlapping window cells summed in the same order: 1e-6
    np.testing.assert_allclose(fold_t.numpy(), fold_j, rtol=1e-6, atol=1e-6)


def test_deposit_sorted_2d_matches_reference():
    pos, vel, valid = _particles(seed=2)
    jt, tt = jx.Tiling2D(**TILE), tp.Tiling2D(**TILE)
    tid, pos_p, validp, _ = jx.build_padded_layout(
        jnp.asarray(pos), SHAPE, jt, jnp.asarray(valid.astype(np.float32)))
    # drift part of the rows past the margin so some of them spill
    pos_p = jnp.mod(pos_p + jnp.asarray(3.0 * np.sign(
        np.random.default_rng(3).standard_normal(pos_p.shape)),
        jnp.float32), jnp.asarray(SHAPE, jnp.float32))
    w = jnp.where(validp > 0.5, 1.25, 0.0)
    g_j, s_j, m_j = jx.deposit_sorted_2d(pos_p, w, tid, SHAPE, jt)
    g_t, s_t, m_t = tp.deposit_sorted_2d(
        torch.tensor(np.asarray(pos_p)), torch.tensor(np.asarray(w)),
        torch.tensor(np.asarray(tid)), SHAPE, tt)
    assert int(s_t) == int(s_j) > 0
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    # same CIC weights; the reference sums per block with f32 matmuls, the
    # port scatters per row: O(10) weights per cell, 1e-5 absolute
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-5)
