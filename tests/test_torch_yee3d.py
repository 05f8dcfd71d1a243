"""The 3D Yee update's wrapper (ops/yee3d.py) on CPU tensors: the same
rolls and differences as the EM model's Yee update before the kernel, bit
for bit, its checks, and no kernel launch or ``yee_fused`` count off the
card."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electromagnetic as em
from fusion_sim_torch.ops import fdtd, yee3d
from fusion_sim_torch.utils import profiling
from torch_ranks import one_torch_thread  # noqa: F401


def _grids(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((*shape, 3)).astype(np.float32))
            for _ in range(n)]


def _composition(config, e, b, j):
    """The EM model's Yee update as it was written before the kernel."""
    dx = config.cell_size
    b_half = fdtd.advance_b_half(b, e, config.dt, dx)
    e_new = fdtd.advance_e_full(e, b_half, j, config.dt, dx, c=config.c,
                                eps0=config.eps0)
    return e_new, fdtd.advance_b_half(b_half, e_new, config.dt, dx)


def _config(shape, cell_size, c=1.0, eps0=1.0):
    return em.EMConfig(grid_shape=shape, cell_size=cell_size, dt=0.05,
                       charge=-0.01, mass=0.01, c=c, eps0=eps0)


@pytest.mark.parametrize("cell_size,c,eps0", [((0.5, 0.5, 0.5), 1.0, 1.0),
                                              ((0.5, 0.25, 0.3), 2.0, 0.7)])
@pytest.mark.parametrize("shape", [(5, 7, 9), (3, 13, 17), (8, 6, 10)])
def test_yee_update_3d_on_cpu_is_the_composition(shape, cell_size, c, eps0):
    cfg = _config(shape, cell_size, c, eps0)
    e, b, j = _grids(shape, sum(shape))
    want = _composition(cfg, e, b, j)
    before = yee3d.LAUNCHES
    for got in (em.yee_update(cfg, e, b, j),
                yee3d.yee_update_3d(e, b, j, cfg.dt, cell_size, c, eps0),
                yee3d.yee_update_3d_plain(e, b, j, cfg.dt, cell_size, c,
                                          eps0)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert yee3d.LAUNCHES == before


@pytest.mark.parametrize("shape,cell_size", [((16, 24), (0.5, 0.7)),
                                             ((9, 5), (0.25, 0.3))])
def test_2d_yee_update_stays_the_composition(shape, cell_size, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a 2D grid reached the 3D Yee update")

    monkeypatch.setattr(yee3d, "yee_update_3d", refuse)
    cfg = _config(shape, cell_size, c=1.5, eps0=0.8)
    e, b, j = _grids(shape, 7)
    got = em.yee_update(cfg, e, b, j)
    want = _composition(cfg, e, b, j)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _bad_inputs(case):
    e, b, j = _grids((4, 5, 6), 3)
    cell = (0.5, 0.5, 0.5)
    if case == "2d grid":
        e, b, j = _grids((4, 5), 3)
    elif case == "float64":
        e = e.double()
    elif case == "non-contiguous e":
        e = e.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mismatched j":
        j = j[:, :, :5].contiguous()
    elif case == "two cell sizes":
        cell = (0.5, 0.5)
    return e, b, j, cell


@pytest.mark.parametrize("case,error", [
    ("2d grid", ValueError), ("float64", TypeError),
    ("non-contiguous e", ValueError), ("mismatched j", ValueError),
    ("two cell sizes", ValueError)])
def test_yee_update_3d_checks_raise_on_cpu(case, error):
    e, b, j, cell = _bad_inputs(case)
    with pytest.raises(error):
        yee3d.yee_update_3d(e, b, j, 0.05, cell)


def test_yee_fused_is_not_counted_on_cpu():
    shape = (4, 6, 8)
    cfg = _config(shape, (0.5, 0.5, 0.5))
    e, b, j = _grids(shape, 11)
    before = yee3d.LAUNCHES
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("probe", 1)
        em.yee_update(cfg, e, b, j)
        counts = profiling.counters()
    assert counts.get("probe") == 1, "the counters record under a profiler"
    assert "yee_fused" not in counts
    assert yee3d.LAUNCHES == before
