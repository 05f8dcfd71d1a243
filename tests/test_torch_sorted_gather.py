"""Port vs reference: the windowed gathers for tile-sorted particles.

``gather_sorted_2d_window`` (kernel B3's wrapper; on the CPU its plain
version) against ``gather_sorted_2d_pallas`` in Pallas interpret mode, and
the port's ``gather_sorted_2d`` against the reference's, in both modes,
for a scalar grid and for C channels (tests/test_pallas_gather.py's
cases).  Positions are jittered off the sorted layout so that some rows
leave their windows; values are compared on in-window rows, in_win on
every valid row.  The CUDA kernel itself is held against the plain version
on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import sorted_gather as tg
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_torch.ops.sorted_deposit import gather_sorted_2d as t_gather
from fusion_sim_tpu.ops.pallas_gather import gather_sorted_2d_pallas
from fusion_sim_tpu.ops.sorted_deposit import Tiling2D as JTiling
from fusion_sim_tpu.ops.sorted_deposit import build_padded_layout
from fusion_sim_tpu.ops.sorted_deposit import gather_sorted_2d as j_gather

SHAPE = (32, 64)
TILE = dict(tile_r=8, tile_z=16, block=128, margin=2)


def _case(channels, seed=1, n=1024):
    """A sorted layout, then a jitter of ~2 cells so rows spill."""
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 2)) * np.array(SHAPE)).astype(np.float32)
    grid = rng.standard_normal(SHAPE + channels).astype(np.float32)
    tid, pos_p, validp, _ = build_padded_layout(
        jnp.asarray(pos), SHAPE, JTiling(**TILE), jnp.ones((n,), jnp.float32))
    keep = np.asarray(validp) > 0.5
    pos_p = np.asarray(pos_p).copy()
    pos_p[keep] += 2.0 * rng.standard_normal((keep.sum(), 2))
    pos_p = np.mod(pos_p, np.array(SHAPE, np.float32)).astype(np.float32)
    return grid, pos_p, np.asarray(tid), keep


@pytest.mark.parametrize("mode,channels", [
    ("nearest", ()), ("nearest", (12,)), ("cic", ()), ("cic", (2,)),
])
def test_window_gather_matches_pallas(mode, channels):
    grid, pos, tid, keep = _case(channels)
    ref_v, ref_in = gather_sorted_2d_pallas(
        jnp.asarray(grid), jnp.asarray(pos), jnp.asarray(tid), SHAPE,
        JTiling(**TILE), mode=mode, interpret=True)
    got_v, got_in = tg.gather_sorted_2d_window(
        torch.tensor(grid), torch.tensor(pos), torch.tensor(tid), SHAPE,
        TTiling(**TILE), mode=mode)
    ref_v, ref_in = np.asarray(ref_v), np.asarray(ref_in)
    assert got_v.shape == ref_v.shape
    np.testing.assert_array_equal(got_in.numpy()[keep], ref_in[keep])
    inw = ref_in & keep
    assert (keep & ~ref_in).sum() > 20, "needs out-of-window rows"
    if mode == "nearest":
        # a selection: the same window cell, so the same f32 value
        np.testing.assert_array_equal(got_v.numpy()[inw], ref_v[inw])
    else:
        # two tent products summed; XLA's dot may fuse one into an FMA
        np.testing.assert_allclose(got_v.numpy()[inw], ref_v[inw],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,channels", [
    ("nearest", ()), ("nearest", (12,)), ("cic", ()), ("cic", (3,)),
])
def test_gather_sorted_2d_matches_reference(mode, channels):
    """The plain route clips the base cell into the window, so every
    valid row (in its window or not) gets the reference's value."""
    grid, pos, tid, keep = _case(channels, seed=2)
    ref_v, ref_in = j_gather(jnp.asarray(grid), jnp.asarray(pos),
                             jnp.asarray(tid), SHAPE, JTiling(**TILE),
                             mode=mode)
    got_v, got_in = t_gather(torch.tensor(grid), torch.tensor(pos),
                             torch.tensor(tid), SHAPE, TTiling(**TILE),
                             mode=mode)
    ref_v = np.asarray(ref_v)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(ref_in))
    if mode == "nearest":
        np.testing.assert_array_equal(got_v.numpy()[keep], ref_v[keep])
    else:
        np.testing.assert_allclose(got_v.numpy()[keep], ref_v[keep],
                                   rtol=1e-6, atol=1e-6)


def test_window_and_plain_routes_agree_in_window():
    """In the window the two routes read the same cells (nearest) or the
    same corners (cic), up to the rare row where x - origin rounds across
    an integer in f32 (ops/sorted_gather.py)."""
    grid, pos, tid, keep = _case((4,), seed=3)
    args = (torch.tensor(grid), torch.tensor(pos), torch.tensor(tid), SHAPE,
            TTiling(**TILE))
    for mode in ("nearest", "cic"):
        a, a_in = tg.gather_sorted_2d_window(*args, mode=mode)
        b, b_in = t_gather(*args, mode=mode)
        assert torch.equal(a_in, b_in)
        inw = (a_in.numpy() & keep)
        np.testing.assert_allclose(a.numpy()[inw], b.numpy()[inw],
                                   rtol=1e-5, atol=1e-5)


def test_window_gather_validates():
    grid, pos, tid, _ = _case(())
    args = (torch.tensor(grid), torch.tensor(pos), torch.tensor(tid), SHAPE,
            TTiling(**TILE))
    with pytest.raises(ValueError, match="mode"):
        tg.gather_sorted_2d_window(*args, mode="linear")
    with pytest.raises(ValueError, match="precision"):
        tg.gather_sorted_2d_window(*args, precision="tf32")
    with pytest.raises(ValueError, match="multiple"):
        tg.gather_sorted_2d_window(args[0], args[1][:100], args[2][:100],
                                   SHAPE, TTiling(**TILE))
