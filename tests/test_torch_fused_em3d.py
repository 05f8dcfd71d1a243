"""Port vs reference: the fused 3D EM substep (kernel B6).

On the CPU ``fused_em3d_substep`` runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode with four blocks a grid step, as
tests/test_pallas_pic.py runs it.  The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fused_em3d as te
from fusion_sim_torch.ops.esirkepov import esirkepov_deposit_3d
from fusion_sim_torch.ops.interp import cic_deposit
from fusion_sim_torch.ops.sorted_deposit import Tiling3D as TTiling
from fusion_sim_tpu.ops.pallas_em3d import fused_em3d_substep as jx_substep
from fusion_sim_tpu.ops.sorted_deposit import Tiling3D as JTiling
from fusion_sim_tpu.ops.sorted_deposit import build_padded_layout
from torch_ranks import one_torch_thread  # noqa: F401

SHAPE = (16, 16, 32)
KW = dict(qm_half_dt=0.1, dt=0.1, cell_size=(0.5, 0.8, 0.6), charge=-0.01)


def _tile(margin=2):
    return dict(tile=(8, 8, 8), block=128, margin=margin)


def _case(vscale, margin=2, seed=3, n=1024, table_scale=1.0):
    """(table, position, velocity, valid, tile_id) as numpy arrays, in the
    reference's layout."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.array(SHAPE)).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    table = (table_scale * rng.standard_normal((*SHAPE, 6))).astype(
        np.float32)
    tid, pos_p, v0, v1, v2, validp, _ = build_padded_layout(
        jnp.asarray(pos), SHAPE, JTiling(**_tile(margin)),
        jnp.asarray(vel[:, 0]), jnp.asarray(vel[:, 1]),
        jnp.asarray(vel[:, 2]), jnp.ones((n,), jnp.float32))
    return [np.asarray(a) for a in (table, pos_p,
                                    jnp.stack([v0, v1, v2], axis=-1),
                                    validp > 0.5, tid)]


def _run_both(arrays, margin=2, relativistic=False, precision="highest",
              c_light=1.0):
    ref = jx_substep(*map(jnp.asarray, arrays), SHAPE,
                     JTiling(**_tile(margin)), relativistic=relativistic,
                     precision=precision, n_g=4, c_light=c_light,
                     interpret=True, **KW)
    got = te.fused_em3d_substep(*map(torch.tensor, arrays), SHAPE,
                                TTiling(**_tile(margin)),
                                relativistic=relativistic,
                                precision=precision, c_light=c_light, **KW)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _compare(ref, got, keep, j_tol=5e-5, row_tol=1.0):
    # the window decisions are comparisons on the same f32 values
    np.testing.assert_array_equal(got[3][keep], ref[3][keep])
    # the invalid rows: the reference's model zeroes them after its kernel
    # (jnp.where on validity), the port's kernel writes them as +0.0
    for i in (0, 1):
        zeroed = np.asarray(jnp.where(jnp.asarray(keep)[:, None], ref[i],
                                      0.0))
        np.testing.assert_array_equal(_bits(got[i][~keep]),
                                      _bits(zeroed[~keep]))
    # the reference gathers with tent matmuls ('highest' f32), the port with
    # direct f32 sums: velocities to 1e-6 relative (4e-6 absolute on a fast
    # row's components near 0), positions to two ulps of a coordinate in the
    # grid's far half (1.9e-6 each below 32 cells)
    np.testing.assert_allclose(got[1][keep], ref[1][keep], rtol=1e-6 * row_tol,
                               atol=4e-6 * row_tol)
    np.testing.assert_allclose(got[0][keep], ref[0][keep], rtol=0,
                               atol=4e-6 * row_tol)
    # a row's current is q (l1 - l0)/dt through window coordinates: one ulp
    # of l1 on a small move is ~1e-4 of that row's J, and ~1e-5 of max|J|
    # where several rows add up: 5e-5 of max|J|
    np.testing.assert_allclose(got[2], ref[2], rtol=0,
                               atol=j_tol * np.abs(ref[2]).max())


@pytest.mark.parametrize("relativistic,vscale,precision", [
    (False, 0.3, "highest"), (True, 1.5, "highest"),
    (False, 0.3, "exact_bf16")])
def test_fused_em3d_substep_matches_reference(relativistic, vscale,
                                              precision):
    arrays = _case(vscale)
    ref, got = _run_both(arrays, relativistic=relativistic,
                         precision=precision)
    keep = arrays[3]
    assert got[3][keep].all()          # no spill at this speed
    if precision == "highest":
        _compare(ref, got, keep)
    else:
        # 'exact_bf16' is the reference's ~2^-18 (4e-6) split of the gather
        # sums: ten times the f32 tolerances on rows, 2e-4 of max|J|
        _compare(ref, got, keep, 2e-4, row_tol=10.0)
    assert got[2].shape == (*SHAPE, 3)


@pytest.mark.parametrize("relativistic,margin", [(False, 1), (True, 2)])
def test_fused_em3d_substep_spill_matches_reference(relativistic, margin):
    """Fast rows: some leave their window (frozen, no deposit), others move
    several cells inside it, which the window-wide tents still cover."""
    # c = 60: gamma up to ~1.3, and the coordinate drift still leaves windows
    c_light = 60.0 if relativistic else 1.0
    arrays = _case(25.0 if relativistic else 12.0, margin=margin, seed=4)
    ref, got = _run_both(arrays, margin, relativistic, c_light=c_light)
    keep = arrays[3]
    spilled = ~got[3] & keep
    assert spilled.sum() > 100, "test needs actual spill"
    _compare(ref, got, keep)
    # spilled rows come back with their input velocity and their input
    # position (through the window frame: to an ulp of the coordinate)
    np.testing.assert_array_equal(got[1][spilled], arrays[2][spilled])
    np.testing.assert_allclose(got[0][spilled], arrays[1][spilled], rtol=0,
                               atol=4e-6)
    # and deposit nothing: the current equals that of the in-window rows
    # alone (their positions and velocities kept, the others uncharged)
    only = [torch.tensor(a) for a in arrays]
    only[3] = only[3] & torch.tensor(got[3])
    j_only = te.fused_em3d_substep(*only, SHAPE, TTiling(**_tile(margin)),
                                   relativistic=relativistic,
                                   c_light=c_light, **KW)[2]
    np.testing.assert_array_equal(got[2], j_only.numpy())


def test_fused_em3d_substep_each_criterion_alone_freezes_rows():
    """Rows moved two tiles away after the sort fail only the gather
    criterion (their drift is tiny); rows given a huge velocity inside
    their window fail only the deposit one.  Both come back frozen."""
    table, pos, vel, valid, tid = _case(0.1, table_scale=0.1)
    real = np.flatnonzero(valid)
    moved, fast = real[::37], real[5::41]
    pos, vel = pos.copy(), vel.copy()
    pos[moved, 2] = np.mod(pos[moved, 2] + 16.0, SHAPE[2])   # two tiles away
    vel[fast, 1] = 120.0                     # 15 cells a step: deposit only
    arrays = [table, pos, vel, valid, tid]
    ref, got = _run_both(arrays)
    assert not got[3][moved].any() and not got[3][fast].any()
    assert got[3][valid].sum() == valid.sum() - len(set(moved) | set(fast))
    _compare(ref, got, valid)
    np.testing.assert_array_equal(got[1][moved], vel[moved])
    np.testing.assert_array_equal(got[1][fast], vel[fast])


def test_invalid_rows_are_pushed_and_sentinel_blocks_have_no_window():
    """An invalid row of a real tile carries no charge and comes back with
    position and velocity +0.0, its in_win the window decision that a
    valid row there gets (the model needs no zeroing pass after the
    kernel).  Rows of sentinel-tile blocks have no window: they come back
    exactly as given with in_win False and deposit nothing, marked valid
    or not (ROADMAP Queue C: the reference pads such blocks to far-out
    coordinates and a trash row)."""
    table, pos, vel, valid, tid = _case(0.1)
    n_tiles = 2 * 2 * 4
    sentinel = tid == n_tiles
    filler = ~valid & ~sentinel
    assert sentinel.any() and filler.any()
    rng = np.random.default_rng(5)
    # fillers and sentinel rows with values of their own, so that a zero
    # written and a value passed through are told apart
    pos = np.where((sentinel | filler)[:, None], rng.random(pos.shape) * 15.0,
                   pos).astype(np.float32)
    vel = np.where((sentinel | filler)[:, None], 1.0, vel).astype(np.float32)
    run = lambda v: [o.numpy() for o in te.fused_em3d_substep(
        *map(torch.tensor, (table, pos, vel, v, tid)), SHAPE,
        TTiling(**_tile()), **KW)]
    base, got = run(valid), run(valid | sentinel)
    for out in (base, got):
        assert not out[3][sentinel].any()
        np.testing.assert_array_equal(_bits(out[0][sentinel]),
                                      _bits(pos[sentinel]))
        np.testing.assert_array_equal(_bits(out[1][sentinel]),
                                      _bits(vel[sentinel]))
        # +0.0, sign bit clear
        assert not _bits(out[0][filler]).any()
        assert not _bits(out[1][filler]).any()
    np.testing.assert_array_equal(got[2], base[2])
    np.testing.assert_array_equal(got[3], base[3])
    # in_win of a filler does not depend on its validity: the rows marked
    # valid take the same window decisions, and are then pushed
    live = run(valid | filler)
    np.testing.assert_array_equal(live[3], base[3])
    inside = filler & base[3]
    assert inside.any() and (filler & ~base[3]).any()
    assert (live[1][inside] != vel[inside]).any(axis=1).all()


def test_fused_em3d_substep_zero_field_matches_exact_deposit():
    """tests/test_pallas_pic.py's check on the port alone: with E = B = 0
    the substep is drift + Esirkepov, and its J equals the exact 3-node
    deposit while moves stay under a cell."""
    dt, cell = 0.2, (0.5, 0.5, 0.5)
    table, pos, vel, valid, tid = _case(1.0, seed=11)
    vel = np.clip(vel, -2.0, 2.0)
    args = [torch.tensor(a) for a in (0 * table, pos, vel, valid, tid)]
    npos, nvel, j, inw = te.fused_em3d_substep(
        *args, SHAPE, TTiling(**_tile()), qm_half_dt=0.3, dt=dt,
        cell_size=cell, charge=-0.01)
    assert bool(inw[args[3]].all())
    x1 = args[1] + dt * args[2] / torch.tensor(cell)
    q = torch.where(args[3], -0.01, 0.0)
    j_ref = esirkepov_deposit_3d(args[1], x1, q, dt, SHAPE, cell)
    np.testing.assert_array_equal(nvel.numpy()[valid], vel[valid])
    np.testing.assert_allclose(j.numpy(), j_ref.numpy(), rtol=0,
                               atol=5e-5 * float(j_ref.abs().max()))


def test_fused_em3d_substep_conserves_charge():
    """Continuity of the kernel's J on its own motion, rows faster than a
    cell included: (rho1 - rho0)/dt + div J = 0 with the positions it
    returns."""
    arrays = [torch.tensor(a) for a in _case(6.0, seed=6)]
    pos1, _, j, inw = te.fused_em3d_substep(*arrays, SHAPE,
                                            TTiling(**_tile()), **KW)
    valid = arrays[3] & inw
    assert int(valid.sum()) > 500
    moved = (pos1 - arrays[1]).abs()[valid]
    assert float(torch.minimum(moved, 32 - moved).max()) > 1.5
    cell = KW["cell_size"]
    w = torch.where(valid, KW["charge"] / float(np.prod(cell)), 0.0)
    rho0 = cic_deposit(arrays[1], w, SHAPE)
    rho1 = cic_deposit(pos1, w, SHAPE)
    div = sum((j[..., a] - torch.roll(j[..., a], 1, a)) / cell[a]
              for a in range(3))
    res = float(((rho1 - rho0) / KW["dt"] + div).abs().max())
    # f32 roundoff of rho/dt, tests/test_sorted_deposit.py's 3D bound
    assert res < 5e-5 * max(float(rho0.abs().max()) / KW["dt"], 1.0)


def test_fused_em3d_substep_validates_arguments():
    arrays = [torch.tensor(a) for a in _case(0.1, n=256)]
    with pytest.raises(ValueError, match="precision"):
        te.fused_em3d_substep(*arrays, SHAPE, TTiling(**_tile()),
                              precision="tf32", **KW)
    with pytest.raises(ValueError, match="multiple"):
        te.fused_em3d_substep(arrays[0], *[a[:-1] for a in arrays[1:]],
                              SHAPE, TTiling(**_tile()), **KW)
    with pytest.raises(ValueError, match="non-finite"):
        te.fused_em3d_substep(*arrays, SHAPE, TTiling(**_tile()),
                              **dict(KW, dt=float("nan")))
