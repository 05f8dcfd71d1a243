"""The 3D node table's wrapper (ops/node_table3d.py) on CPU tensors: the
same rolls and averages as ``fdtd.center_fields``, bit for bit, its
checks, no kernel launch or ``table_fused`` count off the card, and which
table the EM shells take: the wrapper for a 3D grid, ``center_fields``
for a 2D one."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electromagnetic as em
from fusion_sim_torch.ops import fdtd, node_table3d
from fusion_sim_torch.ops.sorted_deposit import Tiling2D, Tiling3D
from fusion_sim_torch.utils import profiling
from torch_ranks import one_torch_thread  # noqa: F401


def _grids(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((*shape, 3)).astype(np.float32))
            for _ in range(n)]


def _config(shape, field_gather="centered"):
    return em.EMConfig(grid_shape=shape, cell_size=(0.5,) * len(shape),
                       dt=0.05, charge=-0.01, mass=0.01,
                       field_gather=field_gather)


@pytest.mark.parametrize("shape", [(5, 7, 9), (3, 13, 17), (8, 6, 10),
                                   (4, 4, 4)])
def test_node_table_3d_on_cpu_is_center_fields(shape):
    e, b = _grids(shape, sum(shape))
    want = fdtd.center_fields(e, b, fdtd.E_OFFSETS_3D, fdtd.B_OFFSETS_3D)
    cfg = _config(shape)
    before = node_table3d.LAUNCHES
    for got in (node_table3d.node_table_3d(e, b),
                node_table3d.node_table_3d_plain(e, b),
                em.node_table(cfg, e, b), em.field_table(cfg, e, b)):
        assert got.shape == (*shape, 6) and got.is_contiguous()
        assert torch.equal(got, want)
    assert em.field_table(_config(shape, "staggered"), e, b) is None
    assert node_table3d.LAUNCHES == before


def _bad_inputs(case):
    e, b = _grids((4, 5, 6), 3)
    if case == "2d grid":
        e, b = _grids((4, 5), 3)
    elif case == "two components":
        e, b = e[..., :2].contiguous(), b[..., :2].contiguous()
    elif case == "float64":
        b = b.double()
    elif case == "non-contiguous b":
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mismatched b":
        b = b[:, :, :5].contiguous()
    elif case == "b on another device":
        b = torch.empty(b.shape, device="meta")
    elif case == "plane past 32-bit ints":
        e, b = (torch.empty((2, 20_000, 20_000, 3), device="meta")
                for _ in range(2))
    elif case == "no kernel for the device":
        e, b = (torch.empty((4, 5, 6, 3), device="meta") for _ in range(2))
    return e, b


@pytest.mark.parametrize("case,error,match", [
    ("2d grid", ValueError, r"\(X, Y, Z, 3\)"),
    ("two components", ValueError, r"\(X, Y, Z, 3\)"),
    ("float64", TypeError, "float32"),
    ("non-contiguous b", ValueError, "contiguous"),
    ("mismatched b", ValueError, "shape"),
    ("b on another device", ValueError, "is on"),
    ("plane past 32-bit ints", ValueError, "32-bit"),
    ("no kernel for the device", ValueError, "no node table kernel")])
def test_node_table_3d_checks_raise(case, error, match):
    e, b = _bad_inputs(case)
    before = node_table3d.LAUNCHES
    with pytest.raises(error, match=match):
        node_table3d.node_table_3d(e, b)
    assert node_table3d.LAUNCHES == before


def test_table_fused_is_not_counted_on_cpu():
    shape = (4, 6, 8)
    e, b = _grids(shape, 11)
    before = node_table3d.LAUNCHES
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("probe", 1)
        em.node_table(_config(shape), e, b)
        counts = profiling.counters()
    assert counts.get("probe") == 1, "the counters record under a profiler"
    assert "table_fused" not in counts
    assert node_table3d.LAUNCHES == before


def _sim(n_dim, gather_backend, n=1024, cells=16, seed=5):
    rng = np.random.default_rng(seed)
    shape = (cells,) * n_dim
    pos = (rng.random((n, n_dim)) * cells).astype(np.float32)
    vel = (0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    e0, b0 = (0.05 * g.numpy() for g in _grids(shape, seed))
    tiling = (Tiling3D((8, 8, 8), 128, margin=1) if n_dim == 3
              else Tiling2D(8, 8, 128, margin=2))
    return em.SortedElectromagneticPIC(
        _config(shape), pos, vel, e=e0, b=b0, tiling=tiling, resort_every=2,
        gather_backend=gather_backend, check_spill=False, spill_capacity=256,
        device="cpu")


@pytest.mark.parametrize("gather_backend", ["fused", "xla"])
def test_2d_shell_table_stays_center_fields(gather_backend, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a 2D grid reached the 3D node table")

    calls = []
    center_fields = fdtd.center_fields

    def record(e, b, e_offsets, b_offsets):
        calls.append(e_offsets)
        return center_fields(e, b, e_offsets, b_offsets)

    monkeypatch.setattr(node_table3d, "node_table_3d", refuse)
    monkeypatch.setattr(fdtd, "center_fields", record)
    sim = _sim(2, gather_backend)
    sim.step(3)
    assert calls == [fdtd.E_OFFSETS_2D] * 3


@pytest.mark.parametrize("gather_backend", ["fused", "xla"])
def test_3d_shell_takes_the_node_table_3d(gather_backend, monkeypatch):
    """One table a step through the wrapper, in both 3D shells."""
    calls = []
    wrapper = node_table3d.node_table_3d

    def record(e, b):
        calls.append(tuple(e.shape))
        return wrapper(e, b)

    monkeypatch.setattr(node_table3d, "node_table_3d", record)
    sim = _sim(3, gather_backend)
    sim.step(3)
    assert calls == [(16, 16, 16, 3)] * 3
