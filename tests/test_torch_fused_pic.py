"""Port vs reference: the fused ES substep (kernel B1).

On the CPU ``fused_es2d_substep`` runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode, as tests/test_pallas_pic.py runs it.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fused_pic as tp
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_tpu.ops.pallas_pic import fused_es2d_substep as jx_substep
from fusion_sim_tpu.ops.sorted_deposit import Tiling2D as JTiling
from fusion_sim_tpu.ops.sorted_deposit import build_padded_layout

SHAPE = (64, 128)
TILE = dict(tile_r=16, tile_z=16, block=128, margin=2)
QM_DT, C_R, C_Z = 0.25, 0.5, 0.5


def _case(vscale, seed=0, n=4096):
    """The inputs of tests/test_pallas_pic.py, in the reference's layout."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 2)) * np.array(SHAPE)).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 2))).astype(np.float32)
    e_grid = rng.standard_normal((*SHAPE, 2)).astype(np.float32)
    tid, pos_p, v0, v1, validp, _ = build_padded_layout(
        jnp.asarray(pos), SHAPE, JTiling(**TILE), jnp.asarray(vel[:, 0]),
        jnp.asarray(vel[:, 1]), jnp.ones((n,), jnp.float32))
    vel_p = jnp.stack([v0, v1], axis=-1)
    w = jnp.where(validp > 0.5, 1.5, 0.0)
    return [np.asarray(a) for a in (e_grid, pos_p, vel_p, w, tid)]


def _run_both(arrays, precision):
    e_grid, pos, vel, w, tid = arrays
    ref = jx_substep(*map(jnp.asarray, arrays), SHAPE, JTiling(**TILE),
                     QM_DT, C_R, C_Z, precision=precision, interpret=True)
    got = tp.fused_es2d_substep(*map(torch.tensor, arrays), SHAPE,
                                TTiling(**TILE), QM_DT, C_R, C_Z,
                                precision=precision)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("precision", ["highest", "exact_bf16_pack"])
def test_fused_es2d_substep_matches_reference(precision):
    arrays = _case(vscale=1.0)
    ref, got = _run_both(arrays, precision)
    keep = arrays[3] > 0    # filler rows report in_win=1 in the reference
    assert got[3][keep].all() and ref[3][keep].all()   # no spill here
    # the reference's tent matmuls ('highest' f32, or the ~2^-18 bf16
    # splits) against the port's direct f32 sums: the gathered E agrees to
    # ~1e-6, so velocities to 1e-5 and positions (c = 0.5, grid-sized
    # magnitudes) to 1e-4 — tests/test_pallas_pic.py's tolerances
    np.testing.assert_allclose(got[1][keep], ref[1][keep], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[0][keep], ref[0][keep], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[2].sum(), arrays[3].sum(), rtol=1e-5)


def test_fused_es2d_substep_spill_matches_reference():
    arrays = _case(vscale=8.0, seed=4)     # drift of ~4 cells > margin 2
    ref, got = _run_both(arrays, "highest")
    keep = arrays[3] > 0
    spilled = ~got[3] & keep
    assert spilled.sum() > 100, "test needs actual spill"
    # the window decisions are exact comparisons on the same f32 values
    np.testing.assert_array_equal(got[3][keep], ref[3][keep])
    # spilled rows come back frozen at their inputs (positions wrapped)
    np.testing.assert_array_equal(got[1][spilled], arrays[2][spilled])
    np.testing.assert_allclose(got[0][keep], ref[0][keep], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[1][keep], ref[1][keep], rtol=1e-4,
                               atol=1e-5)
    # spilled mass is dropped by the kernel (the model patches it)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[2].sum(), arrays[3][~spilled].sum(),
                               rtol=1e-5)


def test_fused_es2d_substep_validates_precision():
    arrays = [torch.tensor(a) for a in _case(vscale=1.0, n=512)]
    with pytest.raises(ValueError, match="precision"):
        tp.fused_es2d_substep(*arrays, SHAPE, TTiling(**TILE), QM_DT, C_R,
                              C_Z, precision="tf32")


def test_sentinel_blocks_are_weightless():
    """Rows of blocks carrying the sentinel tile id (the layout's trailing
    dead blocks) neither kick nor deposit, whatever weight they are given
    (ROADMAP Queue C: the reference gathers them from another tile's
    window and discards their deposit)."""
    e_grid, pos, vel, w, tid = _case(vscale=1.0, n=512)
    n_tiles = (SHAPE[0] // TILE["tile_r"]) * (SHAPE[1] // TILE["tile_z"])
    assert (tid == n_tiles).any() and not (w[tid == n_tiles] != 0).any()
    w = np.where(tid == n_tiles, 2.0, w).astype(np.float32)
    got = tp.fused_es2d_substep(*map(torch.tensor, (e_grid, pos, vel, w,
                                                    tid)),
                                SHAPE, TTiling(**TILE), QM_DT, C_R, C_Z)
    sentinel = tid == n_tiles
    inw = got[3].numpy()
    assert (got[1].numpy()[sentinel & inw] == 0).all()
    real = (w > 0) & ~sentinel
    np.testing.assert_allclose(got[2].numpy().sum(), w[real].sum(),
                               rtol=1e-5)
