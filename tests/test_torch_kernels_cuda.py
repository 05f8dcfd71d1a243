"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  This file imports neither JAX nor the JAX package, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda

Without a CUDA card every test here skips (a kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fused_pic
from fusion_sim_torch.ops.sorted_deposit import Tiling2D, build_padded_layout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("vscale", [0.5, 8.0])   # no spill / heavy spill
def test_fused_es2d_substep_kernel_matches_plain(cuda, vscale):
    """Built with -fmad=false and the plain version's operation order:
    positions, velocities and in_win bit for bit; rho differs only by the
    order of its atomic sums, 1e-5 of max|rho|."""
    shape = (64, 128)
    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    rng = np.random.default_rng(4)
    n = 4096
    pos = torch.tensor(rng.random((n, 2)) * np.array(shape),
                       dtype=torch.float32, device=cuda)
    vel = torch.tensor(vscale * rng.standard_normal((n, 2)),
                       dtype=torch.float32, device=cuda)
    e_grid = torch.tensor(rng.standard_normal((*shape, 2)),
                          dtype=torch.float32, device=cuda)
    tid, pos_p, v0, v1, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], derive_valid=True)
    w = torch.where(valid, 1.5, 0.0).to(torch.float32)
    args = (e_grid, pos_p, torch.stack([v0, v1], -1), w, tid, shape,
            tiling, 0.25, 0.5, 0.5)
    before = fused_pic.LAUNCHES
    got = fused_pic.fused_es2d_substep(*args)
    assert fused_pic.LAUNCHES == before + 1
    plain = fused_pic.fused_es2d_substep_plain(*args)
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        assert torch.equal(got[i], plain[i]), name
    scale = float(plain[2].abs().max())
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5 * scale
    if vscale > 1:
        assert int((~plain[3] & valid).sum()) > 100, "needs actual spill"


@pytest.mark.cuda
def test_fused_es2d_substep_kernel_rejects_bad_inputs(cuda):
    shape = (64, 64)
    tiling = Tiling2D(tile_r=16, tile_z=16, block=128, margin=2)
    n = 256
    e_grid = torch.zeros((*shape, 2), device=cuda)
    pos = torch.zeros((n, 2), device=cuda)
    w = torch.zeros((n,), device=cuda)
    tid = torch.zeros((n,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="tile_id"):
        fused_pic.fused_es2d_substep(e_grid, pos, pos, w, tid.long(), shape,
                                     tiling, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="position"):
        fused_pic.fused_es2d_substep(e_grid, pos.t().contiguous().t(), pos,
                                     w, tid, shape, tiling, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="e_grid"):
        fused_pic.fused_es2d_substep(e_grid.cpu(), pos, pos, w, tid, shape,
                                     tiling, 0.1, 0.1, 0.1)
