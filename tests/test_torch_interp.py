"""Port vs reference: CIC interpolation and spill compaction
(fusion_sim_torch/ops/interp.py against fusion_sim_tpu/ops/interp.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import interp as tp
from fusion_sim_tpu.ops import interp as jx
from torch_ranks import one_torch_thread  # noqa: F401

SHAPES = [(32,), (16, 24), (8, 6, 10)]


def _inputs(shape, n=777, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, len(shape))) * np.array(shape)).astype(np.float32)
    pos[:5] = np.array(shape, np.float32) - 1e-6   # last cell, wraps
    pos[5:10] = 0.0
    w = rng.standard_normal(n).astype(np.float32)
    grid = rng.standard_normal((*shape, 3)).astype(np.float32)
    return pos, w, grid


# f32 on both sides with the same corner arithmetic: deposits agree to the
# order of the scatter sums, gathers to one rounding of the corner sum —
# 1e-6 absolute on O(1) values
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("packed", [True, False])
def test_cic_deposit_matches_reference(shape, packed):
    pos, w, _ = _inputs(shape)
    fj = jx.cic_deposit_packed if packed else jx.cic_deposit
    ft = tp.cic_deposit_packed if packed else tp.cic_deposit
    ref = np.asarray(fj(jnp.asarray(pos), jnp.asarray(w), shape))
    got = ft(torch.tensor(pos), torch.tensor(w), shape).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got.sum(), w.sum(), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("packed", [True, False])
def test_cic_gather_matches_reference(shape, packed):
    pos, _, grid = _inputs(shape, seed=1)
    fj = jx.cic_gather_packed if packed else jx.cic_gather
    ft = tp.cic_gather_packed if packed else tp.cic_gather
    ref = np.asarray(fj(jnp.asarray(grid), jnp.asarray(pos), shape))
    got = ft(torch.tensor(grid), torch.tensor(pos), shape).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # scalar (channel-less) grid
    ref = np.asarray(fj(jnp.asarray(grid[..., 0]), jnp.asarray(pos), shape))
    got = ft(torch.tensor(grid[..., 0]), torch.tensor(pos), shape).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n_spill,capacity", [(0, 16), (5, 16), (40, 16),
                                              (300, 512)])
def test_spill_rows_cond_matches_reference(n_spill, capacity):
    n_total = 3000
    rng = np.random.default_rng(n_spill)
    mask = np.zeros(n_total, bool)
    mask[rng.choice(n_total, n_spill, replace=False)] = True
    spill = int(mask.sum())
    idx_j, ok_j = jx.spill_rows_cond(jnp.asarray(mask), jnp.int32(spill),
                                     capacity, n_total)
    idx_t, ok_t = tp.spill_rows_cond(torch.tensor(mask), spill, capacity,
                                     n_total)
    # the compaction is exact: same indices, same sentinel tail
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    idx_u, ok_u = tp.spill_rows(torch.tensor(mask), spill, capacity, n_total)
    np.testing.assert_array_equal(idx_u.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_u.numpy(), np.asarray(ok_j))


# (rows set, capacities, the caller's count or None): nothing to patch,
# a count inside the second tier, a count past the last capacity, and a
# count the caller already holds on the device (read as given)
@pytest.mark.parametrize("n_spill,capacities,supplied", [
    (0, (16, 64), None), (40, (16, 64), None), (300, (16, 64), None),
    (40, (16, 64), 12)])
def test_patch_rows_matches_reference(n_spill, capacities, supplied,
                                      monkeypatch):
    n_total = 3000
    rng = np.random.default_rng(n_spill)
    mask = np.zeros(n_total, bool)
    mask[rng.choice(n_total, n_spill, replace=False)] = True
    orig, used = tp.spill_rows, []

    def spill_rows(*args):          # records the capacity compacted at
        used.append(args[2])
        return orig(*args)

    monkeypatch.setattr(tp, "spill_rows", spill_rows)
    count = None if supplied is None else torch.tensor(supplied)
    n, idx = tp.patch_rows(torch.tensor(mask), capacities, count)
    spill = n_spill if supplied is None else supplied
    assert n == spill and idx.dtype == torch.int64
    cap = capacities[-1]
    ref = np.asarray(jx.spill_rows(jnp.asarray(mask), jnp.int32(spill), cap,
                                   n_total)[0])
    k = min(spill, cap)
    np.testing.assert_array_equal(idx.numpy(), ref[:k])
    # compacted at the smallest capacity that covers the rows, or not at
    # all when there is nothing to patch
    assert used == ([next(c for c in capacities if k <= c)] if k else [])
