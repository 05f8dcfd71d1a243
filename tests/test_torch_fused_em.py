"""Port vs reference: the fused EM substep (kernel B4).

On the CPU ``fused_em2d_substep`` runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode with two blocks a grid step, as
tests/test_pallas_pic.py runs it.  The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fused_em as te
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_tpu.ops.pallas_em import fused_em2d_substep as jx_substep
from fusion_sim_tpu.ops.sorted_deposit import Tiling2D as JTiling
from fusion_sim_tpu.ops.sorted_deposit import build_padded_layout

SHAPE = (32, 64)
TILE = dict(tile_r=16, tile_z=16, block=128, margin=2)
KW = dict(qm_half_dt=0.1, dt=0.1, cell_size=(0.5, 0.8), charge=-0.01)
N_TILES = (SHAPE[0] // TILE["tile_r"]) * (SHAPE[1] // TILE["tile_z"])


def _case(vscale, seed=3, n=1024):
    """The inputs of tests/test_pallas_pic.py, in the reference's layout:
    (table, position, velocity, valid, tile_id) as numpy arrays."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 2)) * np.array(SHAPE)).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    table = rng.standard_normal((*SHAPE, 6)).astype(np.float32)
    tid, pos_p, v0, v1, v2, validp, _ = build_padded_layout(
        jnp.asarray(pos), SHAPE, JTiling(**TILE), jnp.asarray(vel[:, 0]),
        jnp.asarray(vel[:, 1]), jnp.asarray(vel[:, 2]),
        jnp.ones((n,), jnp.float32))
    return [np.asarray(a) for a in (table, pos_p,
                                    jnp.stack([v0, v1, v2], axis=-1),
                                    validp > 0.5, tid)]


def _run_both(arrays, relativistic=False, precision="highest", c_light=1.0):
    ref = jx_substep(*map(jnp.asarray, arrays), SHAPE, JTiling(**TILE),
                     relativistic=relativistic, precision=precision, n_g=2,
                     c_light=c_light, interpret=True, **KW)
    got = te.fused_em2d_substep(*map(torch.tensor, arrays), SHAPE,
                                TTiling(**TILE), relativistic=relativistic,
                                precision=precision, c_light=c_light, **KW)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _compare(ref, got, keep, j_tol, row_tol=1.0):
    # the window decisions are comparisons on the same f32 values
    np.testing.assert_array_equal(got[3][keep], ref[3][keep])
    # the reference gathers with tent matmuls ('highest' f32), the port
    # with direct f32 sums: the fields agree to ~1e-7, velocities to 1e-6;
    # positions to 8e-6, an ulp of a coordinate at the grid's 64-cell edge
    # (plus two ulps of a fast row's own velocity)
    np.testing.assert_allclose(got[1][keep], ref[1][keep], rtol=2.4e-7,
                               atol=2e-6 * row_tol)
    np.testing.assert_allclose(got[0][keep], ref[0][keep], rtol=0,
                               atol=8e-6 * row_tol)
    # a row's current is q (l1 - l0)/dt through window coordinates: one ulp
    # of l1 (1.9e-6) on a move of ~0.02 cells is 1e-4 of that row's J, and
    # ~1e-5 of max|J| where several rows add up
    np.testing.assert_allclose(got[2], ref[2], rtol=0,
                               atol=j_tol * np.abs(ref[2]).max())


@pytest.mark.parametrize("relativistic,vscale,precision", [
    (False, 0.1, "highest"), (True, 1.5, "highest"),
    (False, 0.1, "exact_bf16")])
def test_fused_em2d_substep_matches_reference(relativistic, vscale,
                                              precision):
    arrays = _case(vscale)
    ref, got = _run_both(arrays, relativistic, precision)
    keep = arrays[3]
    assert got[3][keep].all()          # no spill at this speed
    if precision == "highest":
        _compare(ref, got, keep, 5e-5)
    else:
        # 'exact_bf16' is the reference's ~2^-18 (4e-6) split of the gather
        # sums: ten times the f32 tolerances on rows, 2e-4 of max|J|
        _compare(ref, got, keep, 2e-4, row_tol=10.0)
    assert got[2].shape == (*SHAPE, 3)


@pytest.mark.parametrize("relativistic", [False, True])
def test_fused_em2d_substep_spill_matches_reference(relativistic):
    """Fast rows: some leave their window (frozen, no deposit), others move
    several cells inside it, which the window-wide tents still cover."""
    # c = 60: gamma up to ~1.3, and the coordinate drift still leaves windows
    # (at c = 1 a relativistic row moves under dt/dx = 0.2 cells a step)
    c_light = 60.0 if relativistic else 1.0
    arrays = _case(25.0, seed=4)
    ref, got = _run_both(arrays, relativistic, c_light=c_light)
    keep = arrays[3]
    spilled = ~got[3] & keep
    assert spilled.sum() > 50, "test needs actual spill"
    _compare(ref, got, keep, 5e-5)
    # spilled rows come back with their input velocity and their input
    # position (through the window frame: to an ulp of the coordinate)
    np.testing.assert_array_equal(got[1][spilled], arrays[2][spilled])
    np.testing.assert_allclose(got[0][spilled], arrays[1][spilled], rtol=0,
                               atol=8e-6)
    # and deposit nothing: the current equals that of the in-window rows
    # alone (their positions and velocities kept, the others uncharged)
    only = [torch.tensor(a) for a in arrays]
    only[3] = only[3] & torch.tensor(got[3])
    j_only = te.fused_em2d_substep(*only, SHAPE, TTiling(**TILE),
                                   relativistic=relativistic,
                                   c_light=c_light, **KW)[2]
    np.testing.assert_array_equal(got[2], j_only.numpy())


def test_fused_em2d_substep_gather_criterion_freezes_rows():
    """A row whose input position lies outside its block's window (the
    gather criterion) is frozen whatever its velocity."""
    arrays = _case(0.1)
    table, pos, vel, valid, tid = arrays
    rows = np.flatnonzero(valid)[::37]
    pos = pos.copy()
    pos[rows, 1] = np.mod(pos[rows, 1] + 32.0, SHAPE[1])   # two tiles away
    arrays = [table, pos, vel, valid, tid]
    ref, got = _run_both(arrays)
    assert not got[3][rows].any()
    _compare(ref, got, valid, 5e-5)
    np.testing.assert_array_equal(got[1][rows], vel[rows])


def test_sentinel_blocks_have_no_window():
    """Rows of blocks carrying the sentinel tile id (the layout's trailing
    dead blocks) come back exactly as given with in_win False and deposit
    nothing, even when marked valid, so a model would re-push them exactly
    (ROADMAP Queue C: the reference gathers them from another tile's window
    at the sentinel's origin and discards their deposit)."""
    table, pos, vel, valid, tid = _case(0.1)
    sentinel = tid == N_TILES
    assert sentinel.any() and not valid[sentinel].any()
    rng = np.random.default_rng(5)
    pos = np.where(sentinel[:, None], rng.random(pos.shape) * 30.0,
                   pos).astype(np.float32)
    vel = np.where(sentinel[:, None], 1.0, vel).astype(np.float32)
    base = te.fused_em2d_substep(*map(torch.tensor, (table, pos, vel, valid,
                                                     tid)),
                                 SHAPE, TTiling(**TILE), **KW)
    got = te.fused_em2d_substep(*map(torch.tensor, (table, pos, vel,
                                                    valid | sentinel, tid)),
                                SHAPE, TTiling(**TILE), **KW)
    assert not got[3].numpy()[sentinel].any()
    np.testing.assert_array_equal(got[0].numpy()[sentinel], pos[sentinel])
    np.testing.assert_array_equal(got[1].numpy()[sentinel], vel[sentinel])
    np.testing.assert_array_equal(got[2].numpy(), base[2].numpy())


def test_fused_em2d_substep_validates_arguments():
    arrays = [torch.tensor(a) for a in _case(0.1, n=256)]
    with pytest.raises(ValueError, match="precision"):
        te.fused_em2d_substep(*arrays, SHAPE, TTiling(**TILE),
                              precision="tf32", **KW)
    with pytest.raises(ValueError, match="multiple"):
        te.fused_em2d_substep(arrays[0], *[a[:-1] for a in arrays[1:]],
                              SHAPE, TTiling(**TILE), **KW)
    with pytest.raises(ValueError, match="non-finite"):
        te.fused_em2d_substep(*arrays, SHAPE, TTiling(**TILE),
                              **dict(KW, dt=float("nan")))


def test_fused_em2d_substep_conserves_charge():
    """Continuity of the kernel's J on its own motion: (rho1 - rho0)/dt +
    div J = 0 with the positions it returns."""
    from fusion_sim_torch.ops.interp import cic_deposit

    arrays = [torch.tensor(a) for a in _case(2.0, seed=6)]
    pos1, _, j, inw = te.fused_em2d_substep(*arrays, SHAPE, TTiling(**TILE),
                                            **KW)
    valid = arrays[3]
    assert bool(inw[valid].all())
    dx, dz = KW["cell_size"]
    w = torch.where(valid, KW["charge"] / (dx * dz), 0.0)
    rho0 = cic_deposit(arrays[1], w, SHAPE)
    rho1 = cic_deposit(pos1, w, SHAPE)
    div = ((j[..., 0] - torch.roll(j[..., 0], 1, 0)) / dx
           + (j[..., 1] - torch.roll(j[..., 1], 1, 1)) / dz)
    res = float(((rho1 - rho0) / KW["dt"] + div).abs().max())
    # f32 roundoff of rho/dt, tests/test_sorted_deposit.py's bound
    assert res < 3e-5 * max(float(rho0.abs().max()) / KW["dt"], 1.0)
