"""Port vs reference: the fused 3D ES substep (kernel B5).

On the CPU ``fused_es3d_substep`` runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode with four blocks a grid step, as
tests/test_pallas_pic.py runs it.  The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fused_pic3d as tp
from fusion_sim_torch.ops.interp import cic_deposit_packed, cic_gather_packed
from fusion_sim_torch.ops.sorted_deposit import Tiling3D as TTiling
from fusion_sim_tpu.ops.pallas_pic3d import fused_es3d_substep as jx_substep
from fusion_sim_tpu.ops.sorted_deposit import Tiling3D as JTiling
from fusion_sim_tpu.ops.sorted_deposit import build_padded_layout

SCALARS = (0.25, 0.5, 0.4, 0.6)            # qm_dt, c_x, c_y, c_z


def _case(shape, tile, vscale, seed=7, n=2048):
    """tests/test_pallas_pic.py's inputs in the reference's layout:
    (e_grid, position, velocity, weights, tile_id) as numpy arrays."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.array(shape)).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    e_grid = rng.standard_normal((*shape, 3)).astype(np.float32)
    tid, pos_p, v0, v1, v2, validp, _ = build_padded_layout(
        jnp.asarray(pos), shape, JTiling(**tile), jnp.asarray(vel[:, 0]),
        jnp.asarray(vel[:, 1]), jnp.asarray(vel[:, 2]),
        jnp.ones((n,), jnp.float32))
    w = jnp.where(validp > 0.5, 1.5, 0.0)
    return [np.asarray(a) for a in (e_grid, pos_p,
                                    jnp.stack([v0, v1, v2], axis=-1), w, tid)]


def _run_both(arrays, shape, tile, precision="highest"):
    ref = jx_substep(*map(jnp.asarray, arrays), shape, JTiling(**tile),
                     *SCALARS, precision=precision, n_g=4, interpret=True)
    got = tp.fused_es3d_substep(*map(torch.tensor, arrays), shape,
                                TTiling(**tile), *SCALARS,
                                precision=precision)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _compare(ref, got, keep, tol=1.0):
    # the window decisions are comparisons on the same f32 values
    np.testing.assert_array_equal(got[3][keep], ref[3][keep])
    # the reference gathers with tent matmuls ('highest' f32), the port with
    # direct f32 sums: velocities to 1e-6 relative; positions to two ulps of
    # a coordinate in the grid's far half (1.9e-6 each below 32 cells)
    np.testing.assert_allclose(got[1][keep], ref[1][keep], rtol=1e-6 * tol,
                               atol=2e-6 * tol)
    np.testing.assert_allclose(got[0][keep], ref[0][keep], rtol=0,
                               atol=4e-6 * tol)
    # the same CIC weights summed per tile in another order: 1e-5 of max|rho|
    np.testing.assert_allclose(got[2], ref[2], rtol=0,
                               atol=1e-5 * tol * np.abs(ref[2]).max())


@pytest.mark.parametrize("precision", ["highest", "exact_bf16"])
def test_fused_es3d_substep_matches_reference(precision):
    shape, tile = (16, 16, 32), dict(tile=(8, 8, 8), block=128, margin=2)
    arrays = _case(shape, tile, 1.0)
    ref, got = _run_both(arrays, shape, tile, precision)
    keep = arrays[3] != 0
    assert got[3][keep].all()          # drift under the margin: no spill
    # 'exact_bf16' is the reference's ~2^-18 split of the gather sums and of
    # the deposit weights: ten times the f32 tolerances
    _compare(ref, got, keep, tol=1.0 if precision == "highest"
             else 10.0)
    assert got[2].shape == shape


def test_fused_es3d_substep_spill_matches_reference():
    """Margin 1 and fast rows: many leave their window, come back frozen
    and deposit nothing."""
    shape, tile = (16, 16, 16), dict(tile=(8, 8, 8), block=128, margin=1)
    arrays = _case(shape, tile, 6.0, seed=8)
    ref, got = _run_both(arrays, shape, tile)
    keep = arrays[3] != 0
    spilled = ~got[3] & keep
    assert spilled.sum() > 100, "test needs actual spill"
    _compare(ref, got, keep)
    # spilled rows: input velocity, input position through the window frame
    np.testing.assert_array_equal(got[1][spilled], arrays[2][spilled])
    np.testing.assert_allclose(got[0][spilled], arrays[1][spilled], rtol=0,
                               atol=2e-6)
    # and no deposit: rho equals that of the in-window rows alone
    only = [torch.tensor(a) for a in arrays]
    only[3] = torch.where(torch.tensor(got[3]), only[3], 0.0)
    rho_only = tp.fused_es3d_substep(*only, shape, TTiling(**tile),
                                     *SCALARS)[2]
    np.testing.assert_array_equal(got[2], rho_only.numpy())


def test_fused_es3d_substep_gather_criterion_alone_freezes_rows():
    """Rows moved a tile away after the sort fail only the gather criterion
    (their drift is tiny): frozen whatever the deposit test would say; rows
    with a large velocity inside their window fail only the deposit one."""
    shape, tile = (16, 16, 32), dict(tile=(8, 8, 8), block=128, margin=2)
    e_grid, pos, vel, w, tid = _case(shape, tile, 0.05)
    real = np.flatnonzero(w != 0)
    moved, fast = real[::37], real[5::41]
    pos, vel = pos.copy(), vel.copy()
    pos[moved, 2] = np.mod(pos[moved, 2] + 16.0, shape[2])   # two tiles away
    vel[fast, 0] = 30.0                      # 15 cells a step: deposit only
    arrays = [e_grid, pos, vel, w, tid]
    ref, got = _run_both(arrays, shape, tile)
    keep = w != 0
    assert not got[3][moved].any() and not got[3][fast].any()
    assert got[3][keep].sum() == keep.sum() - len(set(moved) | set(fast))
    _compare(ref, got, keep)
    np.testing.assert_array_equal(got[1][moved], vel[moved])
    np.testing.assert_array_equal(got[1][fast], vel[fast])


def test_weightless_rows_do_not_move_and_sentinel_blocks_have_no_window():
    """A weight-0 row of a real tile gets velocity 0 before the drift.  Rows
    of sentinel-tile blocks (the layout's trailing dead blocks) have no
    window: they come back exactly as given with in_win False and deposit
    nothing, even with weight (ROADMAP Queue C: the reference pads such
    blocks to far-out coordinates and a trash row instead)."""
    shape, tile = (16, 16, 16), dict(tile=(8, 8, 8), block=128, margin=2)
    e_grid, pos, vel, w, tid = _case(shape, tile, 0.3, n=1024)
    n_tiles = 8
    sentinel = tid == n_tiles
    filler = (w == 0) & ~sentinel
    assert sentinel.any() and filler.any()
    rng = np.random.default_rng(5)
    pos = np.where(sentinel[:, None], rng.random(pos.shape) * 15.0,
                   pos).astype(np.float32)
    vel = np.where((sentinel | filler)[:, None], 1.0, vel).astype(np.float32)
    args = lambda wts: [torch.tensor(a) for a in (e_grid, pos, vel, wts, tid)]
    base = tp.fused_es3d_substep(*args(w), shape, TTiling(**tile), *SCALARS)
    got = tp.fused_es3d_substep(
        *args(np.where(sentinel, 2.0, w).astype(np.float32)), shape,
        TTiling(**tile), *SCALARS)
    assert not got[3].numpy()[sentinel].any()
    np.testing.assert_array_equal(got[0].numpy()[sentinel], pos[sentinel])
    np.testing.assert_array_equal(got[1].numpy()[sentinel], vel[sentinel])
    np.testing.assert_array_equal(got[2].numpy(), base[2].numpy())
    # fillers of real tiles: in their window, velocity 0, position kept
    assert got[3].numpy()[filler].all()
    assert not got[1].numpy()[filler].any()
    np.testing.assert_allclose(got[0].numpy()[filler], pos[filler], rtol=0,
                               atol=2e-6)


def test_fused_es3d_substep_plain_matches_composed_step():
    """tests/test_pallas_pic.py's check on the port alone: the substep
    equals packed gather + kick + drift + packed deposit."""
    shape, tile = (16, 16, 32), dict(tile=(8, 8, 16), block=128, margin=2)
    arrays = [torch.tensor(a) for a in _case(shape, tile, 1.0, seed=9)]
    e_grid, pos, vel, w, _ = arrays
    qm_dt, *c = SCALARS
    npos, nvel, rho, inw = tp.fused_es3d_substep(*arrays, shape,
                                                 TTiling(**tile), *SCALARS)
    keep = w != 0
    assert bool(inw[keep].all())
    grid_f = torch.tensor(shape, dtype=torch.float32)
    e_at_p = cic_gather_packed(e_grid, torch.remainder(pos, grid_f), shape)
    vel_ref = torch.where(keep[:, None], vel + qm_dt * e_at_p, 0.0)
    pos_ref = torch.remainder(pos + torch.tensor(c) * vel_ref, grid_f)
    rho_ref = cic_deposit_packed(pos_ref, w, shape)
    np.testing.assert_allclose(nvel[keep].numpy(), vel_ref[keep].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(npos[keep].numpy(), pos_ref[keep].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(rho.numpy(), rho_ref.numpy(), rtol=0,
                               atol=1e-5 * float(rho_ref.abs().max()))


def test_fused_es3d_substep_validates_arguments():
    shape, tile = (16, 16, 16), dict(tile=(8, 8, 8), block=128, margin=1)
    arrays = [torch.tensor(a) for a in _case(shape, tile, 0.1, n=256)]
    with pytest.raises(ValueError, match="precision"):
        tp.fused_es3d_substep(*arrays, shape, TTiling(**tile), *SCALARS,
                              precision="tf32")
    with pytest.raises(ValueError, match="multiple"):
        tp.fused_es3d_substep(arrays[0], *[a[:-1] for a in arrays[1:]],
                              shape, TTiling(**tile), *SCALARS)
    with pytest.raises(ValueError, match="finite"):
        tp.fused_es3d_substep(*arrays, shape, TTiling(**tile), 0.25,
                              float("inf"), 0.5, 0.5)
