"""The 2D3V Yee update's wrapper (ops/yee2d.py) on CPU tensors: the same
rolls and differences as the EM model's Yee update before the kernel, bit
for bit, its checks, no kernel launch or ``yee_fused`` count off the card,
and the 2D shells on CPU tensors still on the rolls."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electromagnetic as em
from fusion_sim_torch.ops import fdtd, yee2d, yee3d
from fusion_sim_torch.ops.sorted_deposit import Tiling2D
from fusion_sim_torch.utils import profiling
from torch_ranks import one_torch_thread  # noqa: F401


def _grids(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((*shape, 3)).astype(np.float32))
            for _ in range(n)]


def _composition(config, e, b, j):
    """The EM model's 2D Yee update as it was written before the kernel."""
    dx = config.cell_size
    b_half = fdtd.advance_b_half(b, e, config.dt, dx)
    e_new = fdtd.advance_e_full(e, b_half, j, config.dt, dx, c=config.c,
                                eps0=config.eps0)
    return e_new, fdtd.advance_b_half(b_half, e_new, config.dt, dx)


def _config(shape, cell_size, c=1.0, eps0=1.0, field_gather="staggered"):
    return em.EMConfig(grid_shape=shape, cell_size=cell_size, dt=0.05,
                       charge=-0.01, mass=0.01, c=c, eps0=eps0,
                       field_gather=field_gather)


# 512^2 (the 2D3V cell's grid), odd, ragged against the kernel's 8 x 64
# tiles, and axes shorter than the halo
SHAPES = [(512, 512), (5, 7), (9, 13), (20, 130), (1, 2), (2, 1)]


@pytest.mark.parametrize("cell_size,c,eps0", [((0.5, 0.5), 1.0, 1.0),
                                              ((0.5, 0.3), 2.0, 0.7)])
@pytest.mark.parametrize("shape", SHAPES)
def test_yee_update_2d_on_cpu_is_the_composition(shape, cell_size, c, eps0):
    cfg = _config(shape, cell_size, c, eps0)
    e, b, j = _grids(shape, sum(shape))
    want = _composition(cfg, e, b, j)
    before = yee2d.LAUNCHES
    for got in (em.yee_update(cfg, e, b, j),
                yee2d.yee_update_2d(e, b, j, cfg.dt, cell_size, c, eps0),
                yee2d.yee_update_2d_plain(e, b, j, cfg.dt, cell_size, c,
                                          eps0)):
        assert got[0].shape == e.shape and got[1].shape == b.shape
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert yee2d.LAUNCHES == before


def _bad_inputs(case):
    e, b, j = _grids((4, 5), 3)
    cell = (0.5, 0.5)
    if case == "3d grid":
        e, b, j = _grids((4, 5, 6), 3)
    elif case == "two components":
        e, b, j = (t[..., :2].contiguous() for t in (e, b, j))
    elif case == "float64":
        e = e.double()
    elif case == "non-contiguous e":
        e = e.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mismatched j":
        j = j[:, :4].contiguous()
    elif case == "j on another device":
        j = torch.empty(j.shape, device="meta")
    elif case == "three cell sizes":
        cell = (0.5, 0.5, 0.5)
    elif case == "grid past 32-bit ints":
        e, b, j = (torch.empty((40_000, 20_000, 3), device="meta")
                   for _ in range(3))
    elif case == "no kernel for the device":
        e, b, j = (torch.empty((4, 5, 3), device="meta") for _ in range(3))
    return e, b, j, cell


@pytest.mark.parametrize("case,error,match", [
    ("3d grid", ValueError, r"\(X, Y, 3\)"),
    ("two components", ValueError, r"\(X, Y, 3\)"),
    ("float64", TypeError, "float32"),
    ("non-contiguous e", ValueError, "contiguous"),
    ("mismatched j", ValueError, "shape"),
    ("j on another device", ValueError, "is on"),
    ("three cell sizes", ValueError, "2 entries"),
    ("grid past 32-bit ints", ValueError, "32-bit"),
    ("no kernel for the device", ValueError, "no Yee kernel")])
def test_yee_update_2d_checks_raise(case, error, match):
    e, b, j, cell = _bad_inputs(case)
    before = yee2d.LAUNCHES
    with pytest.raises(error, match=match):
        yee2d.yee_update_2d(e, b, j, 0.05, cell)
    assert yee2d.LAUNCHES == before


def test_yee_fused_is_not_counted_on_cpu():
    shape = (8, 12)
    cfg = _config(shape, (0.5, 0.5))
    e, b, j = _grids(shape, 11)
    before = yee2d.LAUNCHES
    # outside a recording a count adds nothing and marks the counters
    # stale, so the recording below starts them from zero
    profiling.count("probe", 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("probe", 1)
        em.yee_update(cfg, e, b, j)
        counts = profiling.counters()
    assert counts.get("probe") == 1, "the counters record under a profiler"
    assert "yee_fused" not in counts
    assert yee2d.LAUNCHES == before


def _record_plain(monkeypatch):
    """Every call of the 2D plain update, by grid shape; the 3D wrapper
    refuses."""
    calls = []
    plain = yee2d.yee_update_2d_plain

    def record(e, *args):
        calls.append(tuple(e.shape))
        return plain(e, *args)

    def refuse(*args, **kwargs):
        raise AssertionError("a 2D grid reached the 3D Yee update")

    monkeypatch.setattr(yee2d, "yee_update_2d_plain", record)
    monkeypatch.setattr(yee3d, "yee_update_3d", refuse)
    return calls


@pytest.mark.parametrize("gather_backend", ["fused", "pallas", "xla"])
def test_2d_sorted_shell_on_cpu_takes_the_rolls(gather_backend, monkeypatch):
    calls = _record_plain(monkeypatch)
    rng = np.random.default_rng(5)
    cells, n = 16, 1024
    pos = (rng.random((n, 2)) * cells).astype(np.float32)
    vel = (0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    e0, b0 = (0.05 * g.numpy() for g in _grids((cells, cells), 5, 2))
    before = yee2d.LAUNCHES
    sim = em.SortedElectromagneticPIC(
        _config((cells, cells), (0.5, 0.5), field_gather="centered"), pos,
        vel, e=e0, b=b0, tiling=Tiling2D(8, 8, 128, margin=2),
        resort_every=2, gather_backend=gather_backend, check_spill=False,
        spill_capacity=256, device="cpu")
    sim.step(3)
    assert calls == [(cells, cells, 3)] * 3
    assert yee2d.LAUNCHES == before


@pytest.mark.parametrize("field_gather", ["staggered", "centered"])
def test_2d_plain_model_on_cpu_takes_the_rolls(field_gather, monkeypatch):
    calls = _record_plain(monkeypatch)
    rng = np.random.default_rng(8)
    cells, n = 12, 256
    pos = (rng.random((n, 2)) * cells).astype(np.float32)
    vel = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    sim = em.ElectromagneticPIC(
        _config((cells, cells), (0.5, 0.5), field_gather=field_gather), pos,
        vel, device="cpu")
    sim.step(2)
    assert calls == [(cells, cells, 3)] * 2
