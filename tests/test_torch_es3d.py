"""Port vs reference: the 3D electrostatic models, the slice as a whole.

The sorted models start from the SAME layout (the reference's state carried
across with ``from_state``); after a resort the two agree per tile segment
as sets, so states compare as fields, energies and sorted coordinates.  The
reference's fused kernel runs in Pallas interpret mode (the model picks it
off the TPU); both sides take single steps, so the reference compiles one
step function."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electrostatic as tes
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling2D
from fusion_sim_torch.ops.sorted_deposit import Tiling3D as TTiling
from fusion_sim_tpu.models import electrostatic as jes
from fusion_sim_tpu.ops.sorted_deposit import Tiling3D as JTiling

TILE = dict(tile=(8, 8, 8), block=128, margin=1)


def _setup(n=2048, cells=16, seed=0, vscale=0.5):
    """tests/test_es_sorted.py's 3D setup: L = 2 pi, one plasma period = 2
    pi."""
    length = 2 * np.pi
    d = length / cells
    kw = dict(grid_shape=(cells,) * 3, cell_size=(d,) * 3, dt=0.05,
              charge=-length ** 3 / n, mass=length ** 3 / n)
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * cells).astype(np.float32)
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    return kw, pos, vel


def _carry(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.state._asdict().items()
            if v is not None}


def test_plain_es3d_matches_reference():
    kw, pos, vel = _setup()
    ref = jes.ElectrostaticPIC(jes.ESConfig(**kw), pos, vel)
    port = tes.ElectrostaticPIC(tes.ESConfig(**kw), pos, vel, device="cpu")
    ref.step(4)
    port.step(4)
    # the same f32 formulas over 4 steps; the FFT solves differ by rounding:
    # 2e-5 cells on positions up to 16, 1e-5 on velocities
    np.testing.assert_allclose(port.state.position.numpy(),
                               np.asarray(ref.state.position), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(port.state.velocity.numpy(),
                               np.asarray(ref.state.velocity), rtol=1e-5,
                               atol=1e-5)
    e_r, e_p = ref.energies(), port.energies()
    for key in ("kinetic", "field", "total"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-4)


def test_sorted_es3d_matches_reference_across_a_resort_with_spill():
    """5 single steps at resort_every=3 (the resort runs before step 4);
    speeds that out-run margin 1, so the exact patch runs in both."""
    kw, pos, vel = _setup(vscale=3.0)
    args = dict(resort_every=3, backend="pallas", check_spill=False,
                spill_capacity=512, spill_tiers=(32,))
    ref = jes.SortedElectrostaticPIC(jes.ESConfig(**kw), pos, vel,
                                     tiling=JTiling(**TILE), **args)
    port = tes.SortedElectrostaticPIC.from_state(
        tes.ESConfig(**kw), _carry(ref), tiling=TTiling(**TILE),
        device="cpu", **args)
    assert port.state.position.shape == (2048 + 8 * 128, 3)
    for step in range(5):
        ref.step(1)
        port.step(1)
        assert port.state.spill == int(ref.state.spill), step
        if step == 2:
            # one window from the shared layout: row for row, to rounding
            np.testing.assert_allclose(port.state.position.numpy(),
                                       np.asarray(ref.state.position),
                                       rtol=0, atol=2e-5)
            np.testing.assert_allclose(port.state.velocity.numpy(),
                                       np.asarray(ref.state.velocity),
                                       rtol=1e-5, atol=1e-5)
    assert port._since_sort == ref._since_sort == 2
    assert port.state.spill > 20, "test needs actual spill"
    assert port.state.spill_dropped == int(ref.state.spill_dropped) == 0
    rho_r = np.asarray(ref.state.rho)
    # the carried rho: per-tile f32 sums in another order, 1e-5 of max|rho|
    np.testing.assert_allclose(port.state.rho.numpy(), rho_r, rtol=0,
                               atol=1e-5 * np.abs(rho_r).max())
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
    e_r, e_p = ref.energies(), port.energies()
    for key in ("kinetic", "field", "total"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-4)


def test_sorted_es3d_by_cell_matches_reference_across_a_resort():
    """Both models built from the same particles: the port's layout orders
    each tile's rows by cell (the reference's promises no order inside a
    tile), so from the first step the two agree per tile segment as sets;
    3 steps, the resort and one more step, at speeds that spill past
    margin 1.  At build and after the resort the port's real
    rows follow their cells."""
    from fusion_sim_torch.ops.sorted_deposit import tile_cell_keys

    kw, pos, vel = _setup(vscale=3.0, seed=2)
    args = dict(resort_every=3, backend="pallas", check_spill=False,
                spill_capacity=512, spill_tiers=(32,))
    ref = jes.SortedElectrostaticPIC(jes.ESConfig(**kw), pos, vel,
                                     tiling=JTiling(**TILE), **args)
    port = tes.SortedElectrostaticPIC(tes.ESConfig(**kw), pos, vel,
                                      tiling=TTiling(**TILE), device="cpu",
                                      **args)

    def by_cell():
        st = port.state
        keys = tile_cell_keys(st.position, kw["grid_shape"],
                              TTiling(**TILE))[st.valid].numpy()
        tid = st.tile_id[st.valid].numpy()
        return bool((np.diff(keys)[tid[1:] == tid[:-1]] >= 0).all())

    assert by_cell()
    for _ in range(3):               # single steps: one compiled step
        ref.step(1)
    port.step(3)                     # the window, then the resort
    assert by_cell()
    ref.step(1)                      # the resort, then a step
    port.step(1)
    assert port.state.spill == int(ref.state.spill) > 20, "needs spill"
    assert port.state.spill_dropped == int(ref.state.spill_dropped) == 0
    tid = port.state.tile_id.numpy()
    np.testing.assert_array_equal(tid, np.asarray(ref.state.tile_id))
    valid = port.state.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.state.valid))
    rho_r = np.asarray(ref.state.rho)
    np.testing.assert_allclose(port.state.rho.numpy(), rho_r, rtol=0,
                               atol=1e-5 * np.abs(rho_r).max())
    for name, atol in (("position", 2e-5), ("velocity", 1e-5)):
        a = getattr(port.state, name).numpy()
        b = np.asarray(getattr(ref.state, name))
        for t in np.unique(tid[valid]):
            rows = valid & (tid == t)
            for ax in range(3):
                np.testing.assert_allclose(np.sort(a[rows, ax]),
                                           np.sort(b[rows, ax]), rtol=0,
                                           atol=atol, err_msg=name)
    e_r, e_p = ref.energies(), port.energies()
    for key in ("kinetic", "field", "total"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-4)


def test_sorted_es3d_port_tracks_port_plain_model():
    """tests/test_es_sorted.py's check on the port alone: the sorted 3D
    model follows the plain one through resorts and patched spills, and
    conserves charge."""
    kw, pos, vel = _setup(n=4096, vscale=3.0, seed=1)
    config = tes.ESConfig(**kw)
    plain = tes.ElectrostaticPIC(config, pos, vel, device="cpu")
    fast = tes.SortedElectrostaticPIC(
        config, pos, vel, tiling=TTiling(**TILE), resort_every=3,
        backend="pallas", check_spill=False, device="cpu")
    plain.step(9)
    fast.step(9)
    assert fast.state.spill > 0 and fast.state.spill_dropped == 0
    v = fast.state.valid
    assert int(v.sum()) == 4096
    for name in ("position", "velocity"):
        a = getattr(fast.state, name)[v].numpy()
        b = getattr(plain.state, name).numpy()
        for ax in range(3):
            np.testing.assert_allclose(np.sort(a[:, ax]), np.sort(b[:, ax]),
                                       rtol=0, atol=1e-4, err_msg=name)
    q = float(fast.state.rho.double().sum())
    np.testing.assert_allclose(q, 4096 * config.charge / config.cell_volume,
                               rtol=1e-5)
    e_f, e_p = fast.energies(), plain.energies()
    np.testing.assert_allclose(e_f["kinetic"], e_p["kinetic"], rtol=1e-4)
    np.testing.assert_allclose(e_f["field"], e_p["field"], rtol=1e-3)


def test_sorted_es3d_constructor_defaults_and_what_still_raises():
    kw, pos, vel = _setup(n=512)
    config = tes.ESConfig(**kw)
    sim = tes.SortedElectrostaticPIC(config, pos, vel, backend="pallas",
                                     device="cpu")
    assert sim.tiling == TTiling() == TTiling((8, 8, 8), 512, 1)
    assert sim.state.velocity.shape[1] == 3 and sim.state.rho.shape == (16,) * 3
    blob = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in sim.state._asdict().items()}
    state = tes.sorted_state_from_numpy(blob, device="cpu")
    assert torch.equal(state.position, sim.state.position)
    assert torch.equal(state.rho, sim.state.rho)
    again = tes.SortedElectrostaticPIC.from_state(
        config, dict(blob, rho=None), backend="pallas", device="cpu")
    # no carried rho: seeded from the layout's positions
    np.testing.assert_allclose(again.state.rho.numpy(), sim.state.rho.numpy(),
                               rtol=0, atol=1e-6)
    # 3D backend='xla' and repair are ported (tests/test_torch_repair.py)
    for kw in (dict(backend="xla"), dict(backend="pallas", repair=True)):
        sim = tes.SortedElectrostaticPIC(config, pos, vel, device="cpu", **kw)
        sim.step(1)
        assert sim.state.position.shape[1] == 3
        assert int(sim.state.valid.sum()) == pos.shape[0]
    with pytest.raises(ValueError, match="2D-only"):
        tes.SortedElectrostaticPIC(config, pos, vel, backend="pallas",
                                   pallas_precision="exact_bf16_pack2",
                                   device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        tes.SortedElectrostaticPIC(config, pos[:500], vel[:500],
                                   backend="pallas", device="cpu")
    with pytest.raises((ValueError, AttributeError, TypeError)):
        # a 2D tiling does not tile a 3D grid
        tes.SortedElectrostaticPIC(config, pos, vel, backend="pallas",
                                   tiling=TTiling2D(8, 8, 128, 1),
                                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tes.SortedElectrostaticPIC(config, pos, vel, backend="pallas")
