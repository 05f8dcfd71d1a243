"""Port vs reference: the 3D electromagnetic models, the slice as a whole.

The sorted models start from the SAME layout (the reference's state carried
across with ``from_state``); after a resort the two agree per tile segment
as sets, so states compare as fields, energies and sorted coordinates.  The
reference's fused kernel runs in Pallas interpret mode (the model picks it
off the TPU); both sides take single steps, so the reference compiles one
step function."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electromagnetic as tem
from fusion_sim_torch.ops import sorted_gather
from fusion_sim_torch.ops.interp import cic_deposit
from fusion_sim_torch.ops.sorted_deposit import Tiling3D as TTiling
from fusion_sim_tpu.models import electromagnetic as jem
from fusion_sim_tpu.ops.sorted_deposit import Tiling3D as JTiling

TILE = dict(tile=(8, 8, 8), block=128, margin=1)


def _setup(n=2048, cells=16, seed=0, vscale=0.8, **cfg):
    """tests/test_em_sorted.py's setup in 3D: cell 0.5, dt 0.1."""
    kw = dict(grid_shape=(cells,) * 3, cell_size=(0.5,) * 3, dt=0.1,
              charge=-0.01, mass=0.01, field_gather="centered")
    kw.update(cfg)
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * cells).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    return kw, pos, vel


def _wave(cells, d=0.5, amp=0.05):
    """A transverse wave along x, so the gather and the Boris rotation see
    fields from the first step."""
    x = np.arange(cells) * d
    e0 = np.zeros((cells,) * 3 + (3,), np.float32)
    b0 = np.zeros((cells,) * 3 + (3,), np.float32)
    e0[..., 1] = amp * np.sin(2 * np.pi * x / (cells * d))[:, None, None]
    b0[..., 2] = amp * np.sin(2 * np.pi * x / (cells * d))[:, None, None]
    return e0, b0


def _carry(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.state._asdict().items()
            if v is not None}


def _fields_close(port_state, ref_state, tol):
    for name in ("e", "b"):
        ref = np.asarray(getattr(ref_state, name))
        np.testing.assert_allclose(getattr(port_state, name).numpy(), ref,
                                   rtol=0, atol=tol * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("cfg", [
    dict(field_gather="staggered"),
    dict(field_gather="centered", relativistic=True, particle_chunks=2),
], ids=["staggered", "centered-relativistic-chunks"])
def test_em3d_model_matches_reference(cfg):
    kw, pos, vel = _setup(n=1024, seed=8, **cfg)
    e0, b0 = _wave(16)
    ref = jem.ElectromagneticPIC(jem.EMConfig(**kw), pos, vel, e=e0, b=b0)
    port = tem.ElectromagneticPIC(tem.EMConfig(**kw), pos, vel, e=e0, b=b0,
                                  device="cpu")
    ref.step(3)
    port.step(3)
    assert port.state.step == int(ref.state.step) == 3
    assert port.state.position.shape == (1024, 3)
    # the same f32 formulas on both sides over 3 steps; XLA's CPU code
    # contracts some a*b + c into FMAs: 1e-5 on fields, positions (grid
    # units up to 16) and velocities
    _fields_close(port.state, ref.state, 1e-5)
    np.testing.assert_allclose(port.state.position.numpy(),
                               np.asarray(ref.state.position), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(port.state.velocity.numpy(),
                               np.asarray(ref.state.velocity), rtol=1e-5,
                               atol=1e-6)
    e_r, e_p = ref.energies(), port.energies()
    for key in ("field", "kinetic", "total"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-5)
    g_r = np.asarray(jem.gauss_residual(ref.config, ref.state))
    g_p = tem.gauss_residual(port.config, port.state).numpy()
    np.testing.assert_allclose(g_p, g_r, rtol=0,
                               atol=1e-4 * np.abs(g_r).max())
    # a 3D state carried across as numpy arrays
    state = tem.em_state_from_numpy(port.get_state(), device="cpu")
    assert state.e.shape == (16, 16, 16, 3) and state.step == 3
    assert torch.equal(state.position, port.state.position)


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_sorted_em3d_matches_reference_across_a_resort_with_spill(backend):
    """5 single steps at resort_every=3 (the resort runs before step 4);
    speeds that out-run margin 1, so the exact patch runs in both."""
    kw, pos, vel = _setup(vscale=1.5)
    vel = np.clip(vel, -4.5, 4.5)            # under a cell a step
    e0, b0 = _wave(16)
    args = dict(resort_every=3, gather_backend=backend, check_spill=False,
                spill_capacity=512)
    ref = jem.SortedElectromagneticPIC(jem.EMConfig(**kw), pos, vel, e=e0,
                                       b=b0, tiling=JTiling(**TILE), **args)
    port = tem.SortedElectromagneticPIC.from_state(
        tem.EMConfig(**kw), _carry(ref), tiling=TTiling(**TILE),
        device="cpu", **args)
    assert port.state.position.shape == (2048 + 8 * 128, 3)
    for step in range(5):
        ref.step(1)
        port.step(1)
        assert port.state.spill == int(ref.state.spill), step
        if step == 2:
            # one window from the shared layout: row for row, to rounding
            np.testing.assert_array_equal(port.state.valid.numpy(),
                                          np.asarray(ref.state.valid))
            np.testing.assert_allclose(port.state.position.numpy(),
                                       np.asarray(ref.state.position),
                                       rtol=0, atol=2e-5)
            np.testing.assert_allclose(port.state.velocity.numpy(),
                                       np.asarray(ref.state.velocity),
                                       rtol=1e-5, atol=1e-6)
    assert port._since_sort == ref._since_sort == 2
    assert port.state.spill > 20, "test needs actual spill"
    assert port.state.spill_dropped == int(ref.state.spill_dropped) == 0
    # the reference gathers and deposits with f32 tent matmuls per block,
    # the port with direct sums: rounding-level divergence over 5 steps,
    # 2e-5 of the field scale
    _fields_close(port.state, ref.state, 2e-5)
    e_r, e_p = ref.energies(), port.energies()
    for key in ("field", "kinetic", "total"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-5)
    np.testing.assert_array_equal(port.state.tile_id.numpy(),
                                  np.asarray(ref.state.tile_id))
    valid_r = np.asarray(ref.state.valid)
    valid_p = port.state.valid.numpy()
    assert valid_p.sum() == valid_r.sum() == pos.shape[0]
    for name in ("position", "velocity"):
        a = getattr(port.state, name).numpy()[valid_p]
        b = np.asarray(getattr(ref.state, name))[valid_r]
        for ax in range(3):
            np.testing.assert_allclose(np.sort(a[:, ax]), np.sort(b[:, ax]),
                                       rtol=0, atol=2e-5, err_msg=name)


def _sorted_gauss_residual(sim):
    st, cfg = sim.state, sim.config
    w = torch.where(st.valid, cfg.charge / cfg.cell_volume, 0.0)
    grid_f = torch.tensor(cfg.grid_shape, dtype=torch.float32)
    rho = cic_deposit(torch.remainder(st.position, grid_f), w,
                      cfg.grid_shape)
    rho = rho - rho.mean()
    return float((tem.yee_divergence(cfg, st.e) - rho / cfg.eps0).abs().max())


@pytest.mark.parametrize("backend", ["fused", "xla", "pallas"])
def test_sorted_em3d_port_tracks_port_plain_model_and_keeps_gauss(backend):
    """tests/test_em_sorted.py's checks on the port alone, in 3D: the sorted
    model tracks the plain centered model through resorts and patched
    spills, and Gauss's law residual does not grow.  'pallas' takes the
    'xla' route in 3D (the windowed gather kernel is 2D only)."""
    kw, pos, vel = _setup(n=4096, seed=1)
    config = tem.EMConfig(**kw)
    plain = tem.ElectromagneticPIC(config, pos, vel, device="cpu")
    fast = tem.SortedElectromagneticPIC(
        config, pos, vel, tiling=TTiling(**TILE), resort_every=3,
        gather_backend=backend, check_spill=False, device="cpu")
    r0 = _sorted_gauss_residual(fast)
    launches = sorted_gather.LAUNCHES
    plain.step(9)
    fast.step(9)
    assert sorted_gather.LAUNCHES == launches
    assert fast.state.spill > 0 and fast.state.spill_dropped == 0
    assert int(fast.state.valid.sum()) == 4096
    r1 = _sorted_gauss_residual(fast)
    assert r1 - r0 < 5e-3 * max(r0, 1.0), (r0, r1)
    for name in ("e", "b"):
        want = getattr(plain.state, name)
        np.testing.assert_allclose(
            getattr(fast.state, name).numpy(), want.numpy(), rtol=0,
            atol=3e-4 * max(float(want.abs().max()), 1e-9))
    e_ref, e_fast = plain.energies(), fast.energies()
    np.testing.assert_allclose(e_fast["kinetic"], e_ref["kinetic"],
                               rtol=2e-3)
    np.testing.assert_allclose(e_fast["field"], e_ref["field"], rtol=2e-2)


def test_sorted_em3d_constructor_defaults_and_what_still_raises():
    kw, pos, vel = _setup(n=512)
    config = tem.EMConfig(**kw)
    sim = tem.SortedElectromagneticPIC(config, pos, vel,
                                       gather_backend="fused", device="cpu")
    assert sim.tiling == TTiling() == TTiling((8, 8, 8), 512, 1)
    assert sim.state.position.shape[1] == 3
    assert sim.state.e.shape == (16, 16, 16, 3)
    blob = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in sim.state._asdict().items()}
    state = tem.sorted_em_state_from_numpy(blob, device="cpu")
    assert torch.equal(state.position, sim.state.position)
    assert torch.equal(state.tile_id, sim.state.tile_id)
    # 3D repair is ported (tests/test_torch_repair.py)
    sim = tem.SortedElectromagneticPIC(config, pos, vel, repair=True,
                                       repair_eager=1, device="cpu")
    sim.step(1)
    assert int(sim.state.valid.sum()) == pos.shape[0]
    assert int(sim.state.unplaced) == 0
    with pytest.raises(ValueError, match="2D-only"):
        tem.SortedElectromagneticPIC(config, pos, vel,
                                     pallas_precision="exact_bf16_pack2",
                                     device="cpu")
    with pytest.raises(ValueError, match="CFL"):
        tem.EMConfig(**dict(kw, dt=0.3))
    config1 = tem.EMConfig(grid_shape=(16,), cell_size=(0.5,), dt=0.1,
                           charge=-0.01, mass=0.01)
    with pytest.raises(ValueError, match="2D3V or 3D"):
        tem.make_step_fn(config1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tem.SortedElectromagneticPIC(config, pos, vel,
                                         gather_backend="fused")
        with pytest.raises(RuntimeError, match="CUDA"):
            tem.ElectromagneticPIC(config, pos, vel)
