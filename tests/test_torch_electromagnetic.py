"""Port vs reference: the electromagnetic models, the slice as a whole.

The sorted models start from the SAME layout (the reference's state carried
across with ``from_state``), so trajectories compare row for row until a
resort, and as fields, energies and sorted coordinates after one."""

import warnings

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electromagnetic as tem
from fusion_sim_torch.ops.interp import cic_deposit
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_tpu.models import electromagnetic as jem
from fusion_sim_tpu.ops.sorted_deposit import Tiling2D as JTiling

TILE = dict(tile_r=8, tile_z=8, block=128, margin=2)


def _setup(n=4096, cells=64, seed=0, vscale=0.2, **cfg):
    """tests/test_em_sorted.py's setup."""
    d = 0.5
    kw = dict(grid_shape=(cells, cells), cell_size=(d, d), dt=0.2 * d,
              charge=-0.01, mass=0.01, field_gather="centered")
    kw.update(cfg)
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2)).astype(np.float32) * cells
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    return kw, pos, vel


def _wave(cells, d=0.5, amp=0.05):
    """A transverse wave, so the gather and the Boris rotation see fields
    from the first step."""
    x = np.arange(cells) * d
    e0 = np.zeros((cells, cells, 3), np.float32)
    b0 = np.zeros((cells, cells, 3), np.float32)
    e0[..., 1] = amp * np.sin(2 * np.pi * x / (cells * d))[:, None]
    b0[..., 2] = amp * np.sin(2 * np.pi * x / (cells * d))[:, None]
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
    dict(field_gather="staggered"), dict(field_gather="centered"),
    dict(field_gather="centered", relativistic=True, vscale=1.5),
    dict(field_gather="staggered", particle_chunks=4),
], ids=["staggered", "centered", "relativistic", "chunks"])
def test_em_model_matches_reference(cfg):
    cfg = dict(cfg)
    kw, pos, vel = _setup(n=2048, cells=32, seed=8,
                          vscale=cfg.pop("vscale", 0.2), **cfg)
    e0, b0 = _wave(32)
    ref = jem.ElectromagneticPIC(jem.EMConfig(**kw), pos, vel, e=e0, b=b0)
    port = tem.ElectromagneticPIC(tem.EMConfig(**kw), pos, vel, e=e0, b=b0,
                                  device="cpu")
    for _ in range(2):
        ref.step(2)
        port.step(2)
    assert port.state.step == int(ref.state.step) == 4
    # the same f32 formulas on both sides over 4 steps; XLA's CPU code
    # contracts some a*b + c into FMAs: 1e-5 on fields, positions (grid
    # units up to 32) and velocities
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


def test_get_state_set_state_and_carried_state():
    kw, pos, vel = _setup(n=512, cells=16)
    ref = jem.ElectromagneticPIC(jem.EMConfig(**kw), pos, vel)
    ref.step(1)
    port = tem.ElectromagneticPIC(tem.EMConfig(**kw), pos, vel, device="cpu")
    port.set_state(ref.get_state())
    blob = port.get_state()
    assert blob["step"] == 1
    for key in ("position", "velocity", "e", "b"):
        np.testing.assert_array_equal(blob[key], np.asarray(
            getattr(ref.state, key)))
    state = tem.em_state_from_numpy(blob, device="cpu")
    assert torch.equal(state.e, port.state.e) and state.step == 1


def _sorted_pair(backend, kw, pos, vel, tile=TILE, fields=True, **model_kw):
    e0, b0 = _wave(kw["grid_shape"][0]) if fields else (None, None)
    ref = jem.SortedElectromagneticPIC(
        jem.EMConfig(**kw), pos, vel, e=e0, b=b0, tiling=JTiling(**tile),
        gather_backend=backend, **model_kw)
    port = tem.SortedElectromagneticPIC.from_state(
        tem.EMConfig(**kw), _carry(ref), tiling=TTiling(**tile),
        gather_backend=backend, device="cpu", **model_kw)
    return ref, port


@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_sorted_em_matches_reference_across_a_resort(backend):
    """6 steps at resort_every=4: one whole window (4 steps, then the
    resort) and 2 steps of the next, in both packages."""
    kw, pos, vel = _setup()
    ref, port = _sorted_pair(backend, kw, pos, vel, resort_every=4)
    assert torch.equal(port.state.tile_id,
                       torch.tensor(np.asarray(ref.state.tile_id)))
    ref.step(6)
    port.step(6)
    assert port._since_sort == ref._since_sort == 2
    assert port.state.step == int(ref.state.step) == 6
    assert port.state.spill == int(ref.state.spill)
    assert port.state.spill_dropped == int(ref.state.spill_dropped) == 0
    # the reference gathers and deposits with f32 tent matmuls per block,
    # the port with direct sums: rounding-level divergence over 6 steps,
    # 2e-5 of the field scale (the reference holds its own backends to each
    # other at 1e-4)
    _fields_close(port.state, ref.state, 2e-5)
    e_r, e_p = ref.energies(), port.energies()
    for key in ("field", "kinetic", "total"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-5)
    valid_r = np.asarray(ref.state.valid)
    valid_p = port.state.valid.numpy()
    assert valid_p.sum() == valid_r.sum() == pos.shape[0]
    np.testing.assert_array_equal(port.state.tile_id.numpy(),
                                  np.asarray(ref.state.tile_id))
    # the resort orders rows inside a tile differently (stable torch sort
    # vs the reference's sort): compare per-axis sorted coordinates
    for name, width in (("position", 2), ("velocity", 3)):
        a = getattr(port.state, name).numpy()[valid_p]
        b = np.asarray(getattr(ref.state, name))[valid_r]
        for ax in range(width):
            np.testing.assert_allclose(np.sort(a[:, ax]), np.sort(b[:, ax]),
                                       rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("backend,capacity", [("xla", 4096), ("xla", 16),
                                              ("fused", 16)])
def test_sorted_em_spill_patch_matches_reference(backend, capacity):
    """Fast rows out-run margin 1 with no resort: the exact patch re-pushes
    up to spill_capacity of them, the rest are counted as dropped — the
    same rows in both packages, so states compare row for row."""
    kw, pos, vel = _setup(n=1024, seed=5, vscale=2.0)
    tile = dict(tile_r=16, tile_z=16, block=256, margin=1)
    ref, port = _sorted_pair(backend, kw, pos, vel, tile=tile,
                             resort_every=10 ** 6, check_spill=False,
                             spill_capacity=capacity)
    for _ in range(3):
        ref.step(1)
        port.step(1)
        assert port.state.spill == int(ref.state.spill)
        assert port.state.spill_dropped == int(ref.state.spill_dropped)
    assert port.state.spill > 2 * 16, "test needs actual spill"
    assert (port.state.spill_dropped > 0) == (capacity == 16)
    _fields_close(port.state, ref.state, 2e-5)
    np.testing.assert_array_equal(port.state.valid.numpy(),
                                  np.asarray(ref.state.valid))
    np.testing.assert_allclose(port.state.position.numpy(),
                               np.asarray(ref.state.position), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(port.state.velocity.numpy(),
                               np.asarray(ref.state.velocity), rtol=1e-5,
                               atol=1e-6)


def test_sorted_em_without_fallback_matches_reference_and_warns():
    kw, pos, vel = _setup(n=1024, seed=5, vscale=2.0)
    tile = dict(tile_r=16, tile_z=16, block=256, margin=1)
    ref, port = _sorted_pair("xla", kw, pos, vel, tile=tile,
                             resort_every=10 ** 6, spill_fallback=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ref.step(2)
        port.step(2)
    assert port.state.spill == int(ref.state.spill) > 0
    assert port.state.spill_dropped == int(ref.state.spill_dropped) \
        == port.state.spill
    assert any("APPROXIMATE" in str(w.message) for w in caught
               if "fusion_sim_torch" in str(w.filename)
               or "test_torch" in str(w.filename))
    _fields_close(port.state, ref.state, 2e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_sorted_port_matches_port_plain_model(backend):
    """tests/test_em_sorted.py's check on the port alone: the sorted model
    tracks the plain centered model (with a patched spill along the way)."""
    kw, pos, vel = _setup(n=8192, vscale=1.0)
    config = tem.EMConfig(**kw)
    ref = tem.ElectromagneticPIC(config, pos, vel, device="cpu")
    fast = tem.SortedElectromagneticPIC(
        config, pos, vel, tiling=TTiling(tile_r=16, tile_z=16, block=256,
                                         margin=1),
        resort_every=3, gather_backend=backend, check_spill=False,
        device="cpu")
    for _ in range(3):
        ref.step(3)
        fast.step(3)
    assert fast.state.spill > 0 and fast.state.spill_dropped == 0
    for name in ("e", "b"):
        want = getattr(ref.state, name)
        np.testing.assert_allclose(
            getattr(fast.state, name).numpy(), want.numpy(), rtol=0,
            atol=3e-4 * max(float(want.abs().max()), 1e-9))
    e_ref, e_fast = ref.energies(), fast.energies()
    np.testing.assert_allclose(e_fast["kinetic"], e_ref["kinetic"],
                               rtol=2e-3)
    np.testing.assert_allclose(e_fast["field"], e_ref["field"], rtol=2e-2)


def _sorted_gauss_residual(sim):
    st, cfg = sim.state, sim.config
    w = torch.where(st.valid, cfg.charge / cfg.cell_volume, 0.0)
    grid_f = torch.tensor(cfg.grid_shape, dtype=torch.float32)
    rho = cic_deposit(torch.remainder(st.position, grid_f), w,
                      cfg.grid_shape)
    rho = rho - rho.mean()
    return float((tem.yee_divergence(cfg, st.e) - rho / cfg.eps0).abs().max())


@pytest.mark.parametrize("backend", ["fused", "pallas"])
def test_sorted_em_gauss_law(backend):
    """Esirkepov keeps the discrete continuity equation, so Gauss's law
    residual must not grow over a run (tests/test_em_sorted.py's bound)."""
    kw, pos, vel = _setup(n=8192, seed=1)
    sim = tem.SortedElectromagneticPIC(
        tem.EMConfig(**kw), pos, vel, tiling=TTiling(16, 16, 256, margin=3),
        resort_every=3, gather_backend=backend, device="cpu")
    r0 = _sorted_gauss_residual(sim)
    sim.step(30)
    r1 = _sorted_gauss_residual(sim)
    assert sim.state.spill_dropped == 0
    assert r1 - r0 < 5e-3 * max(r0, 1.0), (r0, r1)


def test_check_spill_warns_once_per_event():
    kw, pos, vel = _setup(n=1024, seed=5, vscale=2.0)
    sim = tem.SortedElectromagneticPIC(
        tem.EMConfig(**kw), pos, vel, tiling=TTiling(16, 16, 256, margin=1),
        resort_every=10 ** 6, spill_capacity=16, gather_backend="fused",
        device="cpu")
    with pytest.warns(RuntimeWarning, match="NOT patched"):
        sim.step(3)
    sim.spill_capacity = 4096
    with pytest.warns(RuntimeWarning, match="exact fallback"):
        sim.step(1)
    sim._resort()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim.step(1)                     # freshly sorted: nothing spills


def test_sorted_constructor_validation_and_not_ported():
    kw, pos, vel = _setup(n=1024)
    config = tem.EMConfig(**kw)
    tiling = TTiling(**TILE)

    def make(**over):
        args = dict(tiling=tiling, device="cpu")
        args.update(over)
        return tem.SortedElectromagneticPIC(config, pos, vel, **args)

    with pytest.raises(ValueError, match="gather_backend"):
        make(gather_backend="triton")
    for backend in ("pallas", "fused"):
        with pytest.raises(ValueError, match="requires spill_fallback"):
            make(gather_backend=backend, spill_fallback=False)
    with pytest.raises(ValueError, match="pallas_precision"):
        make(pallas_precision="tf32")
    for name in ("highest", "exact_bf16", "exact_bf16_pack",
                 "exact_bf16_pack2", "default"):
        assert make(gather_backend="fused",
                    pallas_precision=name).pallas_precision == name
    with pytest.raises(ValueError, match="repair=True requires"):
        make(repair=True, spill_fallback=False)
    with pytest.raises(ValueError, match="multiple"):
        tem.SortedElectromagneticPIC(config, pos[:1000], vel[:1000],
                                     tiling=tiling, device="cpu")
    # repair is ported (tests/test_torch_repair.py), with the reference's
    # validation of its tuning arguments
    for backend in ("xla", "pallas", "fused"):
        sim = make(repair=True, gather_backend=backend)
        sim.step(1)
        assert sim.state.free_idx is not None and sim.repair_free_slots == 256
    with pytest.raises(ValueError, match="requires repair"):
        make(repair_eager=1)
    with pytest.raises(ValueError, match="1..margin"):
        make(repair=True, repair_eager=9)
    with pytest.raises(ValueError, match="eager_capacity"):
        make(repair=True, repair_eager=1, eager_capacity=0)
    # 3D configurations are built now (they raised before the 3D slice);
    # repair still waits there
    from fusion_sim_torch.ops.sorted_deposit import Tiling3D
    cfg3 = tem.EMConfig(grid_shape=(16,) * 3, cell_size=(0.5,) * 3,
                        dt=0.05, charge=-0.01, mass=0.01)
    pos3 = np.zeros((1024, 3), np.float32)
    tiling3 = Tiling3D((8, 8, 8), 128, 1)
    for build in (lambda: tem.SortedElectromagneticPIC(
                      cfg3, pos3, pos3, tiling=tiling3, device="cpu"),
                  lambda: tem.ElectromagneticPIC(cfg3, pos3, pos3,
                                                 device="cpu")):
        sim = build()
        sim.step(1)
        assert sim.state.position.shape[1] == 3 and sim.state.step == 1
    sim = tem.SortedElectromagneticPIC(cfg3, pos3, pos3, tiling=tiling3,
                                       repair=True, device="cpu")
    sim.step(1)
    assert int(sim.state.valid.sum()) == 1024
    with pytest.raises(ValueError, match="CFL"):
        tem.EMConfig(grid_shape=(16, 16), cell_size=(0.5, 0.5), dt=0.4,
                     charge=-0.01, mass=0.01)
    with pytest.raises(ValueError, match="field_gather"):
        tem.ElectromagneticPIC(tem.EMConfig(**dict(kw, field_gather="node")),
                               pos, vel, device="cpu")


@pytest.mark.parametrize("sorted_layout", [False, True])
def test_weibel_matches_reference(sorted_layout):
    args = dict(n_particles=4096, n_cells=32, seed=3,
                sorted_layout=sorted_layout)
    ref = jem.weibel(**args)
    port = tem.weibel(device="cpu", **args)
    assert port.config == tem.EMConfig(**{
        f: getattr(ref.config, f) for f in (
            "grid_shape", "cell_size", "dt", "charge", "mass",
            "field_gather")})
    # the same numpy draws; the sorted shells agree per tile segment
    key = (lambda a: np.sort(a, axis=0)) if sorted_layout else (lambda a: a)
    np.testing.assert_array_equal(key(port.state.position.numpy()),
                                  key(np.asarray(ref.state.position)))
    ref.step(4)
    port.step(4)
    _fields_close(port.state, ref.state, 2e-5)
    np.testing.assert_allclose(port.energies()["total"],
                               ref.energies()["total"], rtol=1e-5)
