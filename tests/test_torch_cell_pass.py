"""The cell pass's plain version (``ops/tile_bucket.order_cells_plain``)
on the CPU: applied to the layout by tile it gives the layout by cell, so
the two-level build (the bucket resort by tile, then each tile's real rows
stably by cell) is the stable sort's layout, row for row."""

import math

import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import tile_bucket
from fusion_sim_torch.ops.sorted_deposit import (
    Tiling2D, Tiling3D, build_padded_layout_plain, tile_ids, tile_ids_3d)


def _inputs(dims, seed):
    """Rows for a layout: positions at random with some past the grid on
    either side and some on cell boundaries, a 3-component velocity, a 1-D
    payload and a validity mask (invalid rows carry junk)."""
    if dims == 2:
        shape, tiling = (64, 128), Tiling2D(16, 16, 128, margin=2)
    else:
        shape, tiling = (32, 32, 64), Tiling3D((8, 8, 8), 128, margin=2)
    n = 8192
    rng = np.random.default_rng(seed)
    pos = rng.random((n, dims)) * np.array(shape)
    pos[:64] = np.floor(pos[:64])               # on cell boundaries
    pos[64:72] = -0.25
    pos[72:80] = np.array(shape) + 0.5
    pos = torch.tensor(pos, dtype=torch.float32)
    vel = torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32)
    w = torch.tensor(rng.random(n), dtype=torch.float32)
    valid = torch.tensor(rng.random(n) < 0.9)
    pos[~valid] = 1e3
    return shape, tiling, pos, vel, w, valid


@pytest.mark.parametrize("derive_valid", [False, True])
@pytest.mark.parametrize("reserve", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("dims", [2, 3])
def test_order_cells_plain_gives_the_layout_by_cell(dims, with_valid,
                                                    reserve, derive_valid):
    """``order_cells_plain`` over the layout by tile, with each tile's real
    row count, equals ``build_padded_layout_plain(..., cell_order=True)``
    in every output; the layout by tile alone does not."""
    shape, tiling, pos, vel, w, valid = _inputs(dims, 10 * dims + reserve)
    kw = dict(valid=valid if with_valid else None, reserve=reserve,
              spread=reserve, derive_valid=derive_valid)
    by_tile = build_padded_layout_plain(pos, shape, tiling, vel, w, **kw)
    ids = (tile_ids if dims == 2 else tile_ids_3d)(pos, shape, tiling)
    n_tiles = math.prod(tiling.n_tiles(shape))
    counts = torch.bincount(ids[valid] if with_valid else ids,
                            minlength=n_tiles)
    got = tile_bucket.order_cells_plain(by_tile, shape, tiling, counts)
    want = build_padded_layout_plain(pos, shape, tiling, vel, w,
                                     cell_order=True, **kw)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), f"output {i} differs"
    assert not torch.equal(by_tile[1], want[1])
