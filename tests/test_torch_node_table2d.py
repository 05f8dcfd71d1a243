"""The 2D3V node table's wrapper (ops/node_table2d.py) on CPU tensors: the
same rolls and averages as ``fdtd.center_fields``, bit for bit, its
checks, no kernel launch or ``table_fused`` count off the card, and the
2D shells on CPU tensors still on ``center_fields``."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electromagnetic as em
from fusion_sim_torch.ops import fdtd, node_table2d, node_table3d
from fusion_sim_torch.ops.sorted_deposit import Tiling2D
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


# 512^2 (the 2D3V cell's grid), odd, ragged against the kernel's 8 x 64
# tiles, and axes shorter than the halo
@pytest.mark.parametrize("shape", [(512, 512), (5, 7), (9, 13), (20, 130),
                                   (1, 2), (2, 1)])
def test_node_table_2d_on_cpu_is_center_fields(shape):
    e, b = _grids(shape, sum(shape))
    want = fdtd.center_fields(e, b, fdtd.E_OFFSETS_2D, fdtd.B_OFFSETS_2D)
    cfg = _config(shape)
    before = node_table2d.LAUNCHES
    for got in (node_table2d.node_table_2d(e, b),
                node_table2d.node_table_2d_plain(e, b),
                em.node_table(cfg, e, b), em.field_table(cfg, e, b)):
        assert got.shape == (*shape, 6) and got.is_contiguous()
        assert torch.equal(got, want)
    assert em.field_table(_config(shape, "staggered"), e, b) is None
    assert node_table2d.LAUNCHES == before


def _bad_inputs(case):
    e, b = _grids((4, 5), 3)
    if case == "3d grid":
        e, b = _grids((4, 5, 6), 3)
    elif case == "two components":
        e, b = e[..., :2].contiguous(), b[..., :2].contiguous()
    elif case == "float64":
        b = b.double()
    elif case == "non-contiguous b":
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mismatched b":
        b = b[:, :4].contiguous()
    elif case == "b on another device":
        b = torch.empty(b.shape, device="meta")
    elif case == "table past 32-bit ints":
        e, b = (torch.empty((20_000, 20_000, 3), device="meta")
                for _ in range(2))
    elif case == "no kernel for the device":
        e, b = (torch.empty((4, 5, 3), device="meta") for _ in range(2))
    return e, b


@pytest.mark.parametrize("case,error,match", [
    ("3d grid", ValueError, r"\(X, Y, 3\)"),
    ("two components", ValueError, r"\(X, Y, 3\)"),
    ("float64", TypeError, "float32"),
    ("non-contiguous b", ValueError, "contiguous"),
    ("mismatched b", ValueError, "shape"),
    ("b on another device", ValueError, "is on"),
    ("table past 32-bit ints", ValueError, "32-bit"),
    ("no kernel for the device", ValueError, "no node table kernel")])
def test_node_table_2d_checks_raise(case, error, match):
    e, b = _bad_inputs(case)
    before = node_table2d.LAUNCHES
    with pytest.raises(error, match=match):
        node_table2d.node_table_2d(e, b)
    assert node_table2d.LAUNCHES == before


def test_table_fused_is_not_counted_on_cpu():
    shape = (8, 12)
    e, b = _grids(shape, 11)
    before = node_table2d.LAUNCHES
    # outside a recording a count adds nothing and marks the counters
    # stale, so the recording below starts them from zero
    profiling.count("probe", 1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("probe", 1)
        em.node_table(_config(shape), e, b)
        counts = profiling.counters()
    assert counts.get("probe") == 1, "the counters record under a profiler"
    assert "table_fused" not in counts
    assert node_table2d.LAUNCHES == before


@pytest.mark.parametrize("gather_backend", ["fused", "pallas", "xla"])
def test_2d_sorted_shell_on_cpu_takes_center_fields(gather_backend,
                                                    monkeypatch):
    """One table a step through the 2D wrapper, which runs
    ``center_fields`` on CPU tensors; the 3D wrapper is never reached."""
    wrapped, plain = [], []
    wrapper, center_fields = node_table2d.node_table_2d, fdtd.center_fields

    def record_wrapper(e, b):
        wrapped.append(tuple(e.shape))
        return wrapper(e, b)

    def record_plain(e, b, e_offsets, b_offsets):
        plain.append((e_offsets, b_offsets))
        return center_fields(e, b, e_offsets, b_offsets)

    def refuse(*args, **kwargs):
        raise AssertionError("a 2D grid reached the 3D node table")

    monkeypatch.setattr(node_table2d, "node_table_2d", record_wrapper)
    monkeypatch.setattr(fdtd, "center_fields", record_plain)
    monkeypatch.setattr(node_table3d, "node_table_3d", refuse)
    rng = np.random.default_rng(5)
    cells, n = 16, 1024
    pos = (rng.random((n, 2)) * cells).astype(np.float32)
    vel = (0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    e0, b0 = (0.05 * g.numpy() for g in _grids((cells, cells), 5))
    before = node_table2d.LAUNCHES
    sim = em.SortedElectromagneticPIC(
        _config((cells, cells)), pos, vel, e=e0, b=b0,
        tiling=Tiling2D(8, 8, 128, margin=2), resort_every=2,
        gather_backend=gather_backend, check_spill=False, spill_capacity=256,
        device="cpu")
    sim.step(3)
    assert wrapped == [(cells, cells, 3)] * 3
    assert plain == [(fdtd.E_OFFSETS_2D, fdtd.B_OFFSETS_2D)] * 3
    assert node_table2d.LAUNCHES == before
