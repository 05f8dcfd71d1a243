"""Kernel B5's roofline (``rooflines/b5.py``) against hand-worked cases
and the rung's numbers, and its reader silent where the cell's kernel is
another or the trace shows no launch of it."""

from types import SimpleNamespace

import pytest

from port_bench import harness, peaks


def test_b5_counts_real_particles_and_grids():
    b5 = harness.load_file("rooflines", "b5")
    assert b5.KERNEL == "es3d_substep_kernel"
    # x, v (3 f32 each) read and written = 48 B a particle; E (3 f32)
    # read and rho (1 f32) written = 16 B a cell
    assert b5.work(2, (2, 2, 2)) == (2 * 48 + 8 * 16, 2 * 133)
    # the rung: 29,997,056 particles on 128^3
    n_bytes, flops = b5.work(29_997_056, (128, 128, 128))
    assert n_bytes == 1_439_858_688 + 33_554_432 == 1_473_413_120
    assert flops == 29_997_056 * 133


def test_b5_bytes_bound_it():
    """0.4398 ms of bytes at 3.35 TB/s against 0.060 ms of operations at
    67 TFLOP/s."""
    b5 = harness.load_file("rooflines", "b5")
    n_bytes, flops = b5.work(29_997_056, (128, 128, 128))
    assert flops / 67e12 < 0.2 * n_bytes / 3.35e12
    assert peaks.least_seconds(n_bytes, flops) == pytest.approx(
        4.3982e-4, rel=1e-4)


def _ctx(kernel, times):
    trace = SimpleNamespace(kernel_times=lambda pattern: [
        t for name, ts in times.items() if pattern in name for t in ts])
    return SimpleNamespace(
        config={"kernel": kernel}, trace=trace, n_particles=29_997_056,
        grid_shape=(128, 128, 128), roofline=harness.Context.roofline)


def test_b5_reader():
    read = harness.load_file("metrics", "b5_roofline").read
    # 0.7652 ms a launch: ~57% of the 0.4398 ms bound
    times = {"(anonymous namespace)::es3d_substep_kernel(float const*)":
             [7.652e-4, 7.652e-4], "other": [1.0]}
    assert read(_ctx("b5", times)) == pytest.approx(
        100 * 4.3982e-4 / 7.652e-4, rel=1e-4)
    assert read(_ctx("b1", times)) is None      # another cell's kernel
    assert read(_ctx("b5", {"other": [1.0]})) is None   # no launch
