"""Port vs reference: Esirkepov current deposition, plain
(ops/esirkepov.py) and tile-sorted (ops/sorted_deposit.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops.esirkepov import (esirkepov_deposit_2d,
                                            esirkepov_deposit_3d)
from fusion_sim_torch.ops.interp import cic_deposit
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_torch.ops.sorted_deposit import esirkepov_sorted_2d
from fusion_sim_tpu.ops import esirkepov as jes
from fusion_sim_tpu.ops import sorted_deposit as jsd

SHAPE = (32, 64)
CELL = (0.7, 1.3)
DT = 0.4
TILE = dict(tile_r=16, tile_z=16, block=128, margin=2)


def _motion(n, seed, reach=0.9):
    """tests/test_sorted_deposit.py's inputs: moves under a cell per axis."""
    rng = np.random.default_rng(seed)
    x0 = rng.random((n, 2)).astype(np.float32) * np.array(SHAPE, np.float32)
    x1 = x0 + ((rng.random((n, 2)) - 0.5) * reach).astype(np.float32)
    vz = rng.standard_normal(n).astype(np.float32)
    return x0, x1, vz


def _continuity_residual(j, x0, x1, w):
    """(rho1 - rho0)/dt + div_Yee J on the port's own output."""
    sh = torch.tensor(SHAPE, dtype=torch.float32)
    rho0 = cic_deposit(torch.remainder(x0, sh), w, SHAPE)
    rho1 = cic_deposit(torch.remainder(x1, sh), w, SHAPE)
    div = ((j[..., 0] - torch.roll(j[..., 0], 1, 0)) / CELL[0]
           + (j[..., 1] - torch.roll(j[..., 1], 1, 1)) / CELL[1])
    return float(((rho1 - rho0) / DT + div).abs().max()), float(
        rho0.abs().max())


@pytest.mark.parametrize("per_particle_charge", [False, True])
def test_esirkepov_deposit_2d_matches_reference(per_particle_charge):
    n = 4096
    x0, x1, vz = _motion(n, 7)
    q = (np.where(np.arange(n) % 3 == 0, 0.0, -1.7).astype(np.float32)
         if per_particle_charge else -1.7)
    ref = np.asarray(jes.esirkepov_deposit_2d(
        jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(vz),
        jnp.asarray(q) if per_particle_charge else q, DT, SHAPE, CELL))
    got = esirkepov_deposit_2d(
        torch.tensor(x0), torch.tensor(x1), torch.tensor(vz),
        torch.tensor(q) if per_particle_charge else q, DT, SHAPE, CELL)
    assert got.shape == (*SHAPE, 3)
    # the same per-particle f32 factors; the grid sums run in another order
    # (one scatter row of 27 channels plus rolls against index_add_ on the
    # 9 nodes): 1e-6 of max|J|
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max(), rtol=0)


def test_esirkepov_deposit_2d_keeps_continuity():
    n = 4096
    x0, x1, vz = _motion(n, 8)
    q = -1.7
    j = esirkepov_deposit_2d(torch.tensor(x0), torch.tensor(x1),
                             torch.tensor(vz), q, DT, SHAPE, CELL)
    w = torch.full((n,), q / (CELL[0] * CELL[1]))
    res, scale = _continuity_residual(j, torch.tensor(x0), torch.tensor(x1),
                                      w)
    # tests/test_sorted_deposit.py's bound: f32 roundoff of rho/dt
    assert res < 3e-5 * max(scale / DT, 1.0)


def test_esirkepov_deposit_3d_is_queued():
    """Was queued with the 3D slice; now it runs: a row at rest deposits no
    current, a moving one a current along its motion only (the comparison
    with the reference is in tests/test_torch_sorted_layout3d.py)."""
    x0 = torch.tensor([[3.2, 4.5, 5.1], [7.7, 2.2, 9.4]])
    x1 = x0 + torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0]])
    j = esirkepov_deposit_3d(x0, x1, -1.7, DT, (16, 16, 16), (0.7, 1.3, 0.9))
    assert j.shape == (16, 16, 16, 3)
    assert float(j[..., 1:].abs().max()) == 0.0
    total = float(j[..., 0].sum())
    # sum Jx * V = q * dx_phys / dt for the moving row
    np.testing.assert_allclose(total * 0.7 * 1.3 * 0.9,
                               -1.7 * 0.3 * 0.7 / DT, rtol=1e-5)


def _sorted_case(seed, push_out):
    """The reference's sorted layout keyed on x0's tiles with x1, vz and
    the charge as payloads; ``push_out`` rows are then moved past the
    margin (x0 and x1 alike), so they spill."""
    n = 4096
    x0, x1, vz = _motion(n, seed)
    qw = np.full(n, -1.7, np.float32)
    tid, x0_s, x1a, x1b, vz_s, qw_s, _ = jsd.build_padded_layout(
        jnp.asarray(x0), SHAPE, jsd.Tiling2D(**TILE), jnp.asarray(x1[:, 0]),
        jnp.asarray(x1[:, 1]), jnp.asarray(vz), jnp.asarray(qw))
    x0_s = np.array(x0_s)
    x1_s = np.stack([np.asarray(x1a), np.asarray(x1b)], -1)
    real = np.flatnonzero(np.asarray(qw_s) != 0)
    moved = real[::max(len(real) // push_out, 1)][:push_out] if push_out \
        else real[:0]
    shift = np.array([TILE["tile_r"] / 2 + TILE["margin"] + 3, 0.0],
                     np.float32)
    x0_s[moved] += shift
    x1_s[moved] += shift
    return [np.asarray(a) for a in (x0_s, x1_s, vz_s, qw_s, tid)], moved


@pytest.mark.parametrize("push_out", [0, 200])
def test_esirkepov_sorted_2d_matches_reference(push_out):
    arrays, moved = _sorted_case(9, push_out)
    x0, x1, vz, qw, tid = arrays
    j_r, spill_r, mask_r = jsd.esirkepov_sorted_2d(
        *map(jnp.asarray, arrays), DT, SHAPE, CELL, jsd.Tiling2D(**TILE))
    j_t, spill_t, mask_t = esirkepov_sorted_2d(
        *map(torch.tensor, arrays), DT, SHAPE, CELL, TTiling(**TILE))
    assert int(spill_t) == int(spill_r)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_r))
    if push_out:
        # every moved row starts at least a margin past its tile's edge...
        assert 0 < int(spill_t) <= push_out
        assert mask_t.numpy()[moved].sum() == int(spill_t)
    else:
        assert int(spill_t) == 0
    j_r = np.asarray(j_r)
    # the reference's 'highest' f32 one-hot matmuls per block against
    # index_add_ on the 9 stencil nodes: summation order only, 2e-6 of max|J|
    np.testing.assert_allclose(j_t.numpy(), j_r,
                               atol=2e-6 * np.abs(j_r).max(), rtol=0)


def test_esirkepov_sorted_2d_equals_plain_on_in_window_rows():
    arrays, _ = _sorted_case(10, 200)
    x0, x1, vz, qw, tid = map(torch.tensor, arrays)
    j_s, _, mask = esirkepov_sorted_2d(x0, x1, vz, qw, tid, DT, SHAPE, CELL,
                                       TTiling(**TILE))
    j_p = esirkepov_deposit_2d(x0, x1, vz, torch.where(mask, 0.0, qw), DT,
                               SHAPE, CELL)
    np.testing.assert_allclose(j_s.numpy(), j_p.numpy(),
                               atol=2e-6 * float(j_p.abs().max()), rtol=0)
    # the spilled rows' current, added by the exact deposit, restores
    # continuity for the whole set (the model's deposit patch)
    j_all = j_s + esirkepov_deposit_2d(x0[mask], x1[mask], vz[mask],
                                       qw[mask], DT, SHAPE, CELL)
    res, scale = _continuity_residual(j_all, x0, x1,
                                      qw / (CELL[0] * CELL[1]))
    assert res < 3e-5 * max(scale / DT, 1.0)
