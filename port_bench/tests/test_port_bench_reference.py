"""The reference against the port's plain path at a small size on the
CPU: one step of each model from the same state, with the layout's
permutation taken out by comparing moments, and the reference's own
charge conservation."""

import math

import numpy as np
import pytest
import torch

from port_bench import check, harness
from port_bench.reference import pic
from port_bench.tests.tiny import tiny_config


def _plasma(config, seed):
    rng = np.random.default_rng(seed)
    shape = config["physics"]["grid_shape"]
    n = config["n_particles"]
    pos = (rng.random((n, len(shape))) * shape).astype(np.float32) % shape
    vel = (0.05 * rng.standard_normal(
        (n, config["velocity_components"]))).astype(np.float32)
    return pos.astype(np.float32), vel


@pytest.mark.parametrize("workload,backend", [
    ("es2d-512sq-10m.thermal-resort", "xla"),
    ("es2d-512sq-10m.thermal-resort", "pallas"),
    ("em3d-128cube-30m.thermal-resort", "xla"),
    ("em3d-128cube-30m.thermal-resort", "fused"),
])
def test_reference_step_matches_the_port(workload, backend):
    config = tiny_config(workload)
    key = next(k for k in config["shell"] if k.endswith("backend"))
    config["shell"][key] = backend
    K = harness.kind(config)
    pos, vel = _plasma(config, 3)
    layout = config["layouts"]["resort"]
    sim = K.build(config, layout, pos, vel, "cpu")
    for _ in range(3):
        sim.step(1)
    before = K.snapshot(sim)
    sim.step(1)
    after = K.snapshot(sim)
    ref = K.reference_after(config, before)
    numbers = K.step_numbers(config, after, ref, before)
    limits = config["limits"]
    for k, v in numbers.items():
        assert v <= limits[k], (k, v)
    # the step moved the plasma: the check would see it stand still
    still = K.step_numbers(config, before, ref, before)
    assert still["moments"] > 10 * limits["moments"]


def test_reference_em_step_conserves_charge():
    config = tiny_config("em3d-128cube-30m.thermal-resort")
    phys = config["physics"]
    pos, vel = _plasma(config, 4)
    x = torch.tensor(pos)
    v = torch.tensor(vel) * 4.0
    shape = tuple(phys["grid_shape"])
    e = torch.zeros(shape + (3,))
    b = torch.zeros(shape + (3,))
    x1, v1, e1, b1 = pic.em_step(phys, x, v, e, b)
    w = torch.full((x.shape[0],), phys["charge"] / math.prod(
        phys["cell_size"]))
    drho = pic.deposit(x1, w, shape) - pic.deposit(x, w, shape)
    div = pic.yee_divergence(e1, phys["cell_size"])
    assert float((div - drho).abs().max()) < 1e-5 * float(drho.abs().max())


def test_reference_es_kick_and_drift():
    config = tiny_config("es2d-512sq-10m.thermal-resort")
    phys = config["physics"]
    pos, vel = _plasma(config, 5)
    x, v = torch.tensor(pos), torch.tensor(vel)
    x1, v1, rho1 = pic.es_step(phys, x, v)
    dx = torch.tensor(phys["cell_size"])
    shape = torch.tensor(phys["grid_shape"], dtype=torch.float32)
    moved = torch.remainder(x + phys["dt"] * v1 / dx, shape)
    assert torch.allclose(moved, x1, atol=1e-5)
    total = float(rho1.double().sum()) * math.prod(phys["cell_size"])
    assert total == pytest.approx(config["n_particles"] * phys["charge"],
                                  rel=1e-5)


def test_gap_and_moments():
    a = torch.ones(4, 4, 2)
    b = a.clone()
    b[1, 2, 1] = 1.5
    assert check.gap(b, a) == pytest.approx(0.5)
    assert check.gap(a, a) == 0.0
    bad = a.clone()
    bad[0, 0, 0] = float("nan")
    assert check.gap(bad, a) == 1.0
    x = torch.tensor([[1.25, 2.0]])
    m = check.moments(x, torch.tensor([[2.0, -1.0]]), (4, 4))
    assert float(m[..., 0].sum()) == pytest.approx(1.0)
    assert float(m[1, 2, 1]) == pytest.approx(0.75 * 2.0)


def test_generator_parameters():
    from port_bench import inputs

    config = tiny_config("es2d-512sq-10m.thermal-resort")
    n = config["n_particles"]
    traffic = {"layout": "resort",
               "populations": [{"share": 0.5, "v_thermal": 0.01,
                                "drift": [0.2, 0.0]},
                               {"share": 0.5, "v_thermal": 0.01,
                                "drift": [-0.2, 0.0]}],
               "clump": {"share": 0.5, "extent": 0.25}}
    x, v = inputs.make(config, traffic, 7, "cpu")
    x2, v2 = inputs.make(config, traffic, 7, "cpu")
    assert torch.equal(x, x2) and torch.equal(v, v2)
    assert x.shape == (n, 2) and v.shape == (n, 2)
    assert float(x.min()) >= 0 and float(x.max()) < 64
    assert float(x[: n // 2].max()) < 16          # the clump's box
    assert float(v[: n // 2, 0].mean()) == pytest.approx(0.2, abs=1e-3)
    assert float(v[n // 2:, 0].mean()) == pytest.approx(-0.2, abs=1e-3)
    assert float(v[:, 1].std()) == pytest.approx(0.01, rel=0.05)
    x3, _ = inputs.make(config, traffic, 8, "cpu")
    assert not torch.equal(x, x3)
