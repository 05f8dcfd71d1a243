"""The benchmark's plain 2D3V electromagnetic reference
(``port_bench/reference/pic2d3v.py``) against the port's sorted 2D3V shell
on the CPU, and against itself.

A small plasma of the configuration ``em2d3v-512sq-10m`` (its physics and
its limits): 64^2 cells, 8 particles a cell in two counter-streaming
beams along z, ``Tiling2D(16, 16, 256, 4)``, seeded random E and B of
amplitude 0.02, so that the step's field change holds the curls and the
current alike.  One step of ``SortedElectromagneticPIC`` on the fused
path (``fused_em2d_substep_plain`` and the plain layout by cell on the
CPU) agrees with one reference step from the same state in the numbers
that decide the benchmark's ``correct``: ``moments``, ``fields`` and
``gauss``, here the change of div E against the change of the charge
(the random E has a divergence of its own).
"""

import json
import math

import numpy as np
import pytest
import torch

from fusion_sim_torch.models.electromagnetic import (EMConfig,
                                                     SortedElectromagneticPIC)
from fusion_sim_torch.ops.sorted_deposit import Tiling2D
from port_bench import harness, inputs
from port_bench.kinds import electromagnetic2d as kind
from port_bench.reference import pic, pic2d3v
from torch_ranks import one_torch_thread  # noqa: F401

CONFIG = json.loads((harness.ROOT / "port_bench/configs/"
                     "em2d3v-512sq-10m.json").read_text())
TRAFFIC = json.loads((harness.ROOT / "port_bench/traffic/"
                      "weibel-resort.json").read_text())
CELLS = 64
FIELD = 0.02


def _small():
    config = json.loads(json.dumps(CONFIG))
    config["physics"]["grid_shape"] = [CELLS, CELLS]
    config["n_particles"] = CELLS * CELLS * 8
    return config


def _state(config, seed):
    """Both beams from the benchmark's generator, and random E and B."""
    x, v = inputs.make(config, TRAFFIC, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    shape = tuple(config["physics"]["grid_shape"]) + (3,)
    e = FIELD * torch.randn(shape, generator=g)
    b = FIELD * torch.randn(shape, generator=g)
    return x, v, e, b


def _port_step(config, x, v, e, b):
    """(before, after) snapshots of one step of the sorted 2D3V shell."""
    phys = config["physics"]
    cfg = EMConfig(grid_shape=tuple(phys["grid_shape"]),
                   cell_size=tuple(phys["cell_size"]), dt=phys["dt"],
                   charge=phys["charge"], mass=phys["mass"],
                   field_gather=phys["field_gather"])
    sim = SortedElectromagneticPIC(
        cfg, x.numpy(), v.numpy(), e=e.numpy(), b=b.numpy(),
        tiling=Tiling2D(16, 16, 256, 4), gather_backend="fused",
        resort_every=12, check_spill=False, device="cpu")
    before = kind.snapshot(sim)
    sim.step(1)
    assert sim.state.spill_dropped == 0
    return before, kind.snapshot(sim)


def _numbers(config, after, ref, before):
    out = kind.step_numbers(config, after, ref, before)
    change = dict(after, e=after["e"] - before["e"])
    out.update(kind.end_numbers(config, change, before["x"], before["v"]))
    return out


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 7])
def test_port_step_matches_reference(seed):
    config = _small()
    before, after = _port_step(config, *_state(config, seed))
    ref = kind.reference_after(config, before)
    numbers = _numbers(config, after, ref, before)
    limits = config["limits"]
    assert set(numbers) == {"count", "moments", "fields", "gauss"}
    for k, value in numbers.items():
        assert value <= limits[k], (k, value)
    # the step moved the plasma and changed the fields: a state left
    # as it was fails by far
    still = _numbers(config, before, ref, before)
    assert still["moments"] > 10 * limits["moments"]
    assert still["fields"] > 10 * limits["fields"]


def test_bfloat16_reference_fails():
    config = _small()
    before, _ = _port_step(config, *_state(config, 5))
    ref = kind.reference_after(config, before)
    low = kind.reference_after(config, before, torch.bfloat16)
    numbers = _numbers(config, low, ref, before)
    limits = config["limits"]
    assert [k for k, v in numbers.items() if v > limits[k]], numbers


def test_reference_current_conserves_charge():
    """(rho(x1) - rho(x0)) / dt + div J = 0 to float32 rounding of the
    charge for the in-plane current, and the out-of-plane current sums to
    q v_z / V over the rows."""
    config = _small()
    phys = config["physics"]
    shape, dx = tuple(phys["grid_shape"]), tuple(phys["cell_size"])
    x0, v, _, _ = _state(config, 9)
    v = 2.0 * v                      # up to ~0.5 of a cell a step
    x1 = x0 + phys["dt"] * v[:, :2] / torch.tensor(dx)
    j = pic2d3v.esirkepov(x0, x1, v[:, 2], phys["charge"], phys["dt"],
                          shape, dx)
    w = torch.full((x0.shape[0],), phys["charge"] / math.prod(dx))
    rho0 = pic.deposit(x0, w, shape)
    drho = (pic.deposit(x1, w, shape) - rho0) / phys["dt"]
    div = pic2d3v.yee_divergence(j, dx)
    # float32 rounding of the charge's sums, at the charge's own scale
    assert float((drho + div).abs().max()) \
        < 1e-5 * float(rho0.abs().max()) / phys["dt"]
    assert float(div.abs().max()) > 0.1 * float(drho.abs().max())
    jz = float(j[..., 2].double().sum()) * math.prod(dx)
    assert jz == pytest.approx(phys["charge"] * float(v[:, 2].double().sum()),
                               rel=1e-4)


def test_node_table_is_the_ports():
    """The reference's node table is ``fdtd.center_fields`` with the 2D
    offsets, bit for bit."""
    from fusion_sim_torch.ops import fdtd

    g = torch.Generator().manual_seed(1)
    e, b = torch.randn((2, 8, 6, 3), generator=g)
    want = fdtd.center_fields(e, b, fdtd.E_OFFSETS_2D, fdtd.B_OFFSETS_2D)
    assert torch.equal(pic2d3v.center(e, b), want)
    np.testing.assert_array_equal(pic2d3v.E_OFFSETS, fdtd.E_OFFSETS_2D)
    np.testing.assert_array_equal(pic2d3v.B_OFFSETS, fdtd.B_OFFSETS_2D)


def test_b4_roofline_counts_real_particles_and_grids():
    """x (2 f32) and v (3 f32) read and written = 40 B a particle; the
    table (6 f32) read and J (3 f32) written = 36 B a cell."""
    from port_bench import peaks

    b4 = harness.load_file("rooflines", "b4")
    assert b4.work(2, (2, 2)) == (2 * 40 + 4 * 36, 2 * 270)
    n_bytes, flops = b4.work(10_002_432, (512, 512))
    assert n_bytes == 10_002_432 * 40 + 262_144 * 36
    # bytes bound it at the rung: 0.1222 ms against 0.040 ms of operations
    assert peaks.least_seconds(n_bytes, flops) == pytest.approx(
        n_bytes / 3.35e12)
    assert peaks.least_seconds(n_bytes, flops) == pytest.approx(1.2225e-4,
                                                                rel=1e-3)
