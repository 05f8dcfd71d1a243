"""Port vs reference: the electrostatic models, the slice as a whole.

The sorted models start from the SAME layout (the reference's state carried
across with ``from_state``), so trajectories compare row for row."""

import warnings

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electrostatic as tes
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_tpu.models import electrostatic as jes
from fusion_sim_tpu.ops.sorted_deposit import Tiling2D as JTiling


def _setup(n, cells=64, seed=0, vscale=1.0):
    """tests/test_es_sorted.py's setup."""
    length = 2 * np.pi
    d = length / cells
    vol = length * length
    kw = dict(grid_shape=(cells, cells), cell_size=(d, d), dt=0.05,
              charge=-vol / n, mass=vol / n)
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2)).astype(np.float32) * cells
    vel = (vscale * 0.05 * rng.standard_normal((n, 2))).astype(np.float32)
    return kw, pos, vel


def _carry(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.state._asdict().items()
            if v is not None}


def _pair(n, seed, vscale, tile, **kw):
    cfg, pos, vel = _setup(n, seed=seed, vscale=vscale)
    ref = jes.SortedElectrostaticPIC(jes.ESConfig(**cfg), pos, vel,
                                     tiling=JTiling(**tile), backend="pallas",
                                     **kw)
    port = tes.SortedElectrostaticPIC.from_state(
        tes.ESConfig(**cfg), _carry(ref), tiling=TTiling(**tile),
        backend="pallas", device="cpu", **kw)
    return ref, port


def test_sorted_pallas_matches_reference_row_for_row():
    """The non-slow case of test_es_sorted.py's spill-tier test: fast drift
    out-runs margin 1, so the spill count walks across both tiers."""
    ref, port = _pair(1024, 5, 6.0, dict(tile_r=16, tile_z=16, block=256,
                                         margin=1),
                      resort_every=10 ** 6, check_spill=False,
                      spill_capacity=512, spill_tiers=(8, 64))
    for _ in range(4):
        ref.step(1)
        port.step(1)
        assert port.state.spill == int(ref.state.spill)
        assert port.state.spill_dropped == int(ref.state.spill_dropped)
    assert port.state.spill > 0, "test needs actual spill"
    # f32 trajectories over 4 steps: the reference gathers/deposits with
    # tent matmuls and solves with dense DFTs, the port with direct sums
    # and FFTs — rounding-level divergence, 1e-4
    np.testing.assert_allclose(port.state.position.numpy(),
                               np.asarray(ref.state.position),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.state.velocity.numpy(),
                               np.asarray(ref.state.velocity),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(port.state.valid.numpy(),
                                  np.asarray(ref.state.valid))


def test_sorted_pallas_resort_window_matches_reference():
    """One resort window: 8 steps at resort_every=4 runs two windows, each
    four steps and then a resort, in both packages."""
    ref, port = _pair(4096, 2, 1.0, dict(tile_r=16, tile_z=16, block=256,
                                         margin=3), resort_every=4)
    ref.step(8)
    port.step(8)
    assert port._since_sort == ref._since_sort == 0
    assert port.state.step == int(ref.state.step) == 8
    e_r, e_p = ref.energies(), port.energies()
    for key in ("kinetic", "field", "total"):
        # energies are sums over the rounding-level-divergent state
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-4)
    pos_r = np.asarray(ref.state.position)[np.asarray(ref.state.valid)]
    pos_p = port.state.position[port.state.valid].numpy()
    assert pos_p.shape == pos_r.shape
    for ax in range(2):
        # the resort orders rows inside a tile differently (stable torch
        # sort vs the reference's sort): compare per-axis sorted positions
        np.testing.assert_allclose(np.sort(pos_p[:, ax]),
                                   np.sort(pos_r[:, ax]), atol=1e-3)


def test_sorted_port_matches_port_reference_model():
    """The port's sorted main path tracks the port's plain packed model
    (tests/test_es_sorted.py's check, at the pallas backend)."""
    cfg, pos, vel = _setup(8192)
    config = tes.ESConfig(**cfg)
    ref = tes.ElectrostaticPIC(config, pos, vel, device="cpu")
    fast = tes.SortedElectrostaticPIC(
        config, pos, vel, tiling=TTiling(tile_r=16, tile_z=16, block=256,
                                         margin=3),
        resort_every=4, backend="pallas", device="cpu")
    for _ in range(3):
        ref.step(4)
        fast.step(4)
    assert fast.state.spill == 0
    e_ref, e_fast = ref.energies(), fast.energies()
    # the sorted path solves from the carried (previous-step) rho, so the
    # two agree to the reference test's physics tolerances
    np.testing.assert_allclose(e_fast["kinetic"], e_ref["kinetic"],
                               rtol=2e-3)
    np.testing.assert_allclose(e_fast["field"], e_ref["field"], rtol=2e-2)
    pos_f = fast.state.position[fast.state.valid].numpy()
    pos_r = ref.state.position.numpy()
    for ax in range(2):
        np.testing.assert_allclose(np.sort(pos_f[:, ax]),
                                   np.sort(pos_r[:, ax]), atol=0.05)


def test_spill_tiers_match_single_tier_and_warn():
    cfg, pos, vel = _setup(1024, seed=5, vscale=6.0)
    config = tes.ESConfig(**cfg)
    kw = dict(tiling=TTiling(tile_r=16, tile_z=16, block=256, margin=1),
              resort_every=10 ** 6, spill_capacity=512, backend="pallas",
              device="cpu")
    a = tes.SortedElectrostaticPIC(config, pos, vel, check_spill=False, **kw)
    b = tes.SortedElectrostaticPIC(config, pos, vel, spill_tiers=(8, 64),
                                   **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(6):
            a.step(1)
            b.step(1)
    assert b.state.spill == a.state.spill > 0
    assert torch.equal(a.state.position, b.state.position)
    assert torch.equal(a.state.velocity, b.state.velocity)
    assert any("exact fallback" in str(w.message) for w in caught)


def test_sorted_constructor_validation_and_not_ported():
    cfg, pos, vel = _setup(1024)
    config = tes.ESConfig(**cfg)
    tiling = TTiling(tile_r=16, tile_z=16, block=256, margin=2)
    for bad in [(0,), (64, 8), (8, 8), (512,)]:
        with pytest.raises(ValueError, match="spill_tiers"):
            tes.SortedElectrostaticPIC(config, pos, vel, tiling=tiling,
                                       spill_capacity=512, spill_tiers=bad,
                                       backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="pallas_precision"):
        tes.SortedElectrostaticPIC(config, pos, vel, tiling=tiling,
                                   backend="pallas", pallas_precision="tf32",
                                   device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        tes.SortedElectrostaticPIC(config, pos[:1000], vel[:1000],
                                   tiling=tiling, backend="pallas",
                                   device="cpu")
    # backend='xla' and repair are ported (tests/test_torch_repair.py);
    # their validation is the reference's
    for kw in (dict(backend="xla"), dict(backend="pallas", repair=True),
               dict(backend="xla", repair=True, repair_eager=2)):
        sim = tes.SortedElectrostaticPIC(config, pos, vel, tiling=tiling,
                                         device="cpu", **kw)
        sim.step(1)
        assert int(sim.state.valid.sum()) == 1024
        assert (sim.state.rho is None) == (kw["backend"] == "xla")
        assert (sim.state.free_idx is None) == (not kw.get("repair"))
    for kw, match in ((dict(repair=True, spill_fallback=False), "requires"),
                      (dict(repair_eager=1), "requires repair"),
                      (dict(repair=True, repair_eager=3), "1..margin"),
                      (dict(repair=True, repair_eager=1, eager_capacity=0),
                       "eager_capacity"),
                      (dict(repair=True, spill_capacity=512,
                            spill_tiers=(64,)), "incompatible")):
        with pytest.raises(ValueError, match=match):
            tes.SortedElectrostaticPIC(config, pos, vel, tiling=tiling,
                                       device="cpu", **kw)


@pytest.mark.parametrize("factory,kw", [
    ("two_stream", dict(n_particles=4096, n_cells=64)),
    ("landau", dict(n_particles=4096, n_cells=32)),
])
def test_1d_scenarios_match_reference(factory, kw):
    ref = getattr(jes, factory)(**kw)
    port = getattr(tes, factory)(device="cpu", **kw)
    np.testing.assert_array_equal(port.state.position.numpy(),
                                  np.asarray(ref.state.position))
    for _ in range(2):
        ref.step(3)
        port.step(3)
    # f32 packed CIC + FFT on both sides, 6 steps: rounding-level, 1e-4
    np.testing.assert_allclose(port.state.position.numpy(),
                               np.asarray(ref.state.position),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.state.velocity.numpy(),
                               np.asarray(ref.state.velocity),
                               rtol=1e-4, atol=1e-5)
    e_r, e_p = ref.energies(), port.energies()
    np.testing.assert_allclose(e_p["total"], e_r["total"], rtol=1e-4)
    np.testing.assert_allclose(
        tes.momentum(port.config, port.state).numpy(),
        np.asarray(jes.momentum(ref.config, ref.state)), rtol=1e-3,
        atol=1e-6)
