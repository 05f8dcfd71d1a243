"""Port vs reference: the EM 2D fused shell's layout by cell.

With ``gather_backend='fused'`` the 2D EM shell orders each tile's rows by
cell (``build_padded_layout(cell_order=True)``) at build and at every
resort, so that kernel B4 sums a warp's rows of one cell before it adds
them.  The reference's sort promises no order inside a tile: the two agree
on tile ids, validity and padding, and on each tile segment as a set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electromagnetic as tem
from fusion_sim_torch.ops import sorted_deposit as tp
from fusion_sim_tpu.models import electromagnetic as jem
from fusion_sim_tpu.ops import sorted_deposit as jx

SHAPE = (32, 64)
TILE = dict(tile_r=8, tile_z=16, block=128, margin=2)


def _segments(tid, rows):
    """tile -> sorted list of row tuples."""
    return {int(t): sorted(map(tuple, rows[tid == t].tolist()))
            for t in np.unique(tid)}


@pytest.mark.parametrize("with_valid,reserve", [(False, False),
                                                (True, False), (True, True)])
def test_build_padded_layout_2d_by_cell_matches_reference(with_valid,
                                                          reserve):
    """The reference's tile ids, validity and padding exactly, each tile
    segment the same rows as a set, and inside each segment the real rows
    in the order of their cell inside the tile (z fastest; computed here
    with numpy), fillers last."""
    rng = np.random.default_rng(3)
    n = 2048
    pos = (rng.random((n, 2)) * np.array(SHAPE)).astype(np.float32)
    pos[:3] = np.array(SHAPE, np.float32)   # mod edge: clipped to last tile
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    jt, tt = jx.Tiling2D(**TILE), tp.Tiling2D(**TILE)
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
    rows_j = np.column_stack([np.asarray(o) for o in outj[1:5]])
    rows_t = np.column_stack([o.numpy() for o in outt[1:5]])
    assert _segments(tid_t, rows_t) == _segments(tid_j, rows_j)
    base = np.clip(np.floor(outt[1].numpy()).astype(np.int64), 0,
                   np.array(SHAPE) - 1)
    local = base % np.array([TILE["tile_r"], TILE["tile_z"]])
    cell = local[:, 0] * TILE["tile_z"] + local[:, 1]
    real = outt[5].numpy()
    n_tiles = (SHAPE[0] // TILE["tile_r"]) * (SHAPE[1] // TILE["tile_z"])
    for t in range(n_tiles):
        seg = np.flatnonzero(tid_t == t)
        r = real[seg]
        assert not (r[1:] & ~r[:-1]).any(), "fillers after the real rows"
        assert (np.diff(cell[seg][r]) >= 0).all(), f"tile {t} not by cell"


def test_sorted_em2d_fused_by_cell_matches_reference_across_a_resort():
    """Both fused models built from the same particles at speeds that
    spill past margin 2: 3 steps, the resort, one more step.  The port's
    rows follow their cells at build and after the resort.  The same f32
    formulas on both sides, summed in another order: fields to 2e-5 of
    their scale, each tile's coordinates as sets to 2e-5 (positions, grid
    units up to 64) and 1e-5 (velocities), energies to 1e-5."""
    d = 0.5
    kw = dict(grid_shape=SHAPE, cell_size=(d, d), dt=0.2 * d, charge=-0.01,
              mass=0.01, field_gather="centered")
    rng = np.random.default_rng(4)
    n = 4096
    pos = (rng.random((n, 2)) * np.array(SHAPE)).astype(np.float32)
    vel = (3.0 * rng.standard_normal((n, 3))).astype(np.float32)
    x = np.arange(SHAPE[0]) * d
    e0 = np.zeros((*SHAPE, 3), np.float32)
    b0 = np.zeros((*SHAPE, 3), np.float32)
    e0[..., 1] = 0.05 * np.sin(2 * np.pi * x / (SHAPE[0] * d))[:, None]
    b0[..., 2] = 0.05 * np.sin(2 * np.pi * x / (SHAPE[0] * d))[:, None]
    args = dict(resort_every=3, gather_backend="fused", check_spill=False,
                spill_capacity=1024)
    ref = jem.SortedElectromagneticPIC(jem.EMConfig(**kw), pos, vel, e=e0,
                                       b=b0, tiling=jx.Tiling2D(**TILE),
                                       **args)
    port = tem.SortedElectromagneticPIC(tem.EMConfig(**kw), pos, vel, e=e0,
                                        b=b0, tiling=tp.Tiling2D(**TILE),
                                        device="cpu", **args)

    def by_cell():
        st = port.state
        keys = tp.tile_cell_keys(st.position, SHAPE,
                                 tp.Tiling2D(**TILE))[st.valid].numpy()
        tid = st.tile_id[st.valid].numpy()
        return bool((np.diff(keys)[tid[1:] == tid[:-1]] >= 0).all())

    assert by_cell()
    ref.step(3)                      # the window, then the resort
    port.step(3)
    assert by_cell()
    ref.step(1)
    port.step(1)
    assert port.state.spill == int(ref.state.spill) > 20, "needs spill"
    assert port.state.spill_dropped == int(ref.state.spill_dropped) == 0
    tid = port.state.tile_id.numpy()
    np.testing.assert_array_equal(tid, np.asarray(ref.state.tile_id))
    valid = port.state.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.state.valid))
    for name in ("e", "b"):
        want = np.asarray(getattr(ref.state, name))
        np.testing.assert_allclose(getattr(port.state, name).numpy(), want,
                                   rtol=0, atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)
    for name, width, atol in (("position", 2, 2e-5), ("velocity", 3, 1e-5)):
        a = getattr(port.state, name).numpy()
        b = np.asarray(getattr(ref.state, name))
        for t in np.unique(tid[valid]):
            rows = valid & (tid == t)
            for ax in range(width):
                np.testing.assert_allclose(np.sort(a[rows, ax]),
                                           np.sort(b[rows, ax]), rtol=0,
                                           atol=atol, err_msg=name)
    e_r, e_p = ref.energies(), port.energies()
    for key in ("field", "kinetic", "total"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-5)
