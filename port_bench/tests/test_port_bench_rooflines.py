"""The rooflines' byte and operation counts against hand-worked cases,
and the least time against the published H100 rates."""

import pytest

from port_bench import harness, peaks


def test_b1_counts_real_particles_and_grids():
    b1 = harness.load_file("rooflines", "b1")
    # 10 particles: x, v (2 f32 each) read and written = 32 B each;
    # a 4 x 4 grid: E (2 f32) read, rho written = 12 B a cell
    assert b1.work(10, (4, 4)) == (10 * 32 + 16 * 12, 10 * 56)
    # the headline: 9,999,360 particles on 512^2
    n_bytes, flops = b1.work(9_999_360, (512, 512))
    assert n_bytes == 319_979_520 + 3_145_728
    assert peaks.least_seconds(n_bytes, flops) == pytest.approx(
        323_125_248 / 3.35e12)


def test_b6_counts_real_particles_and_grids():
    b6 = harness.load_file("rooflines", "b6")
    # x, v (3 f32 each) read and written = 48 B; table 24 B and J 12 B
    assert b6.work(2, (2, 2, 2)) == (2 * 48 + 8 * 36, 2 * 700)
    n_bytes, flops = b6.work(29_997_056, (128, 128, 128))
    assert n_bytes == 29_997_056 * 48 + 2_097_152 * 36
    # bytes bound it: 1.515 GB at 3.35 TB/s against 2.1e10 f32 operations
    assert peaks.least_seconds(n_bytes, flops) == pytest.approx(
        n_bytes / 3.35e12)


def test_solves():
    poisson = harness.load_file("rooflines", "poisson_fft")
    n_bytes, flops = poisson.work(0, (4, 4))
    assert n_bytes == 16 * (4 + 8)
    assert flops == pytest.approx(2 * 2.5 * 16 * 4 + 16 * 7)
    yee = harness.load_file("rooflines", "yee_update")
    assert yee.work(0, (2, 2, 2)) == (8 * 60, 8 * 54)


def test_least_seconds_takes_the_longer_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)
