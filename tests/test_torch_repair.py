"""Port vs reference: incremental layout repair (``ops/repair.py``), the
``reserve``/``spread`` layouts, ``sort_by_tile``, ES ``backend='xla'``, and
``repair=True`` in the ES, EM and pusher models (modelled on
tests/test_repair.py).

Two kinds of comparison, stated per test:
* row for row — where the reference's order is defined: the stack
  operations (stable argsorts on both sides), and every model run that
  starts from the reference's own layout (carried across with
  ``from_state``) and resorts no more, so slot assignment, validity and the
  free stacks must agree exactly and values to f32 rounding;
* per tile segment as sets — after a sort (``lax.sort`` orders rows
  inside a tile differently from the port's stable sort)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fusion_sim_torch.models import electromagnetic as tem
from fusion_sim_torch.models import electrostatic as tes
from fusion_sim_torch.ops import repair as tr
from fusion_sim_torch.ops import sorted_deposit as tsd
from fusion_sim_tpu.models import electromagnetic as jem
from fusion_sim_tpu.models import electrostatic as jes
from fusion_sim_tpu.ops import repair as jr
from fusion_sim_tpu.ops import sorted_deposit as jsd


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _carry(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()
            if v is not None and k != "key"}


def _segments(tid, rows):
    """{tile: sorted rows} of a layout."""
    return {int(t): rows[tid == t][np.lexsort(rows[tid == t].T)]
            for t in np.unique(tid)}


# -- ops/repair.py --------------------------------------------------------------

def test_init_free_list_matches_reference():
    """Row for row, on the reference's own layouts (plain and reserve +
    spread), with and without the spare row."""
    rng = np.random.default_rng(0)
    n, cells = 512, 16
    jt = jsd.Tiling2D(tile_r=8, tile_z=8, block=128, margin=2)
    pos = jnp.asarray(rng.random((n, 2)) * cells, jnp.float32)
    valid_in = jnp.arange(n) % 3 != 0
    for kw in (dict(), dict(valid=valid_in, reserve=True),
               dict(reserve=True, spread=True)):
        tid, _, valid, _ = jsd.build_padded_layout(
            pos, (cells, cells), jt, derive_valid=True, **kw)
        for spare in (False, True):
            want = jr.init_free_list(tid, valid, 4, jt.block, 64, spare=spare)
            got = tr.init_free_list(torch.tensor(np.asarray(tid)),
                                    torch.tensor(np.asarray(valid)), 4,
                                    jt.block, 64, spare=spare)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stack_operations_match_reference():
    """pop_slots, push_slots and allocate_slots on random stacks and
    requests (sentinels, full stacks, trailing-tile sources, overflowing
    pushes), row for row; then the reference's hand-built case."""
    rng = np.random.default_rng(1)
    n_total, rows, cap, k = 1000, 6, 5, 40
    cnt = rng.integers(0, cap + 1, rows)
    fidx = np.full((rows, cap), n_total, np.int32)
    for t in range(rows):
        fidx[t, :cnt[t]] = rng.choice(n_total, cnt[t], replace=False)
    src = rng.choice(n_total, k, replace=False).astype(np.int32)
    src[-3:] = n_total
    ok = src < n_total
    new_t = rng.integers(0, rows, k).astype(np.int32)
    old_t = rng.integers(0, rows + 1, k).astype(np.int32)   # some trailing
    want_pop = rng.random(k) < 0.8
    J = [jnp.asarray(x) for x in (fidx, cnt.astype(np.int32), src, ok,
                                  new_t, old_t, want_pop)]
    T = [torch.tensor(x.astype(np.int64) if x.dtype != bool else x)
         for x in (fidx, cnt, src, ok, new_t, old_t, want_pop)]
    for g, w in zip(tr.pop_slots(T[0], T[1], T[4], T[6], n_total),
                    jr.pop_slots(J[0], J[1], J[4], J[6], n_total)):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    for g, w in zip(tr.push_slots(T[0], T[1], T[2], T[5], T[3]),
                    jr.push_slots(J[0], J[1], J[2], J[5], J[3])):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    got = tr.allocate_slots(T[0], T[1], T[2], T[3], T[4], T[5], n_total,
                            rows)
    want = jr.allocate_slots(J[0], J[1], J[2], J[3], J[4], J[5], n_total,
                             rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert 0 < int(got[4]) < int(ok.sum())       # some placed, some not

    # tests/test_repair.py::test_allocate_slots_pop_and_push
    free_idx = torch.tensor([[10, 11, 12, 100], [20, 100, 100, 100],
                             [100] * 4])
    dest, placed, fidx2, fcnt2, nun = tr.allocate_slots(
        free_idx, torch.tensor([3, 1, 0]), torch.tensor([50, 51, 52, 53, 100]),
        torch.tensor([True, True, True, True, False]),
        torch.tensor([0, 0, 1, 2, 0]), torch.tensor([1, 1, 0, 0, 0]), 100, 3)
    assert placed.tolist() == [True, True, True, False, False]
    assert {int(dest[0]), int(dest[1])} == {11, 12} and int(dest[2]) == 20
    assert int(dest[3]) == 53 and int(nun) == 1
    assert fcnt2.tolist() == [2, 2, 0] and 52 in fidx2[0, :2].tolist()


def test_near_band_mask_and_relocate_match_reference():
    """near_band_mask in 2D and 3D (random positions around their tiles,
    periodic wrap included) and relocate, row for row; plus the
    reference's hand-built geometry."""
    rng = np.random.default_rng(2)
    for shape, jt, tt in (
            ((32, 32), jsd.Tiling2D(8, 8, 128, margin=3),
             tsd.Tiling2D(8, 8, 128, margin=3)),
            ((16, 16, 16), jsd.Tiling3D((8, 8, 8), 128, margin=3),
             tsd.Tiling3D((8, 8, 8), 128, margin=3))):
        n_tiles = int(np.prod(tt.n_tiles(shape)))
        tid = rng.integers(0, n_tiles + 1, 512).astype(np.int32)
        pos = (rng.random((512, len(shape))) * np.array(shape)).astype(
            np.float32)
        for keep in (1, 2, 3):
            want = jr.near_band_mask(jnp.asarray(pos), jnp.asarray(tid),
                                     shape, jt, keep)
            got = tr.near_band_mask(torch.tensor(pos), torch.tensor(tid),
                                    shape, tt, keep)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="exceeds margin"):
        tr.near_band_mask(torch.zeros((1, 2)), torch.zeros(1), (32, 32),
                          tsd.Tiling2D(8, 8, 128, margin=1), 2)
    tiling = tsd.Tiling2D(tile_r=8, tile_z=8, block=128, margin=3)
    pos = torch.tensor([[12.0, 12.0], [7.5, 12.0], [5.5, 12.0], [17.9, 12.0],
                        [18.1, 12.0], [12.0, 18.1], [29.5, 4.0],
                        [31.5, 4.0]])
    tid = torch.tensor([5] * 6 + [0, 0])
    assert tr.near_band_mask(pos, tid, (32, 32), tiling, keep=1).tolist() \
        == [False, False, True, False, True, True, True, False]

    n = 64
    arrays = [rng.standard_normal((n, 3)).astype(np.float32),
              rng.standard_normal(n).astype(np.float32)]
    valid = rng.random(n) < 0.5
    src = np.array([3, 9, 17, 40, n], np.int64)
    dest = np.array([11, 9, 5, 40, n], np.int64)
    placed = np.array([True, False, True, False, False])
    vals = [rng.standard_normal((5, 3)).astype(np.float32),
            rng.standard_normal(5).astype(np.float32)]
    want_arr, want_valid = jr.relocate(
        tuple(jnp.asarray(a) for a in arrays), jnp.asarray(valid),
        jnp.asarray(src), jnp.asarray(dest), jnp.asarray(placed),
        tuple(jnp.asarray(v) for v in vals), n)
    got_arr, got_valid = tr.relocate(
        tuple(torch.tensor(a) for a in arrays), torch.tensor(valid),
        torch.tensor(src), torch.tensor(dest), torch.tensor(placed),
        tuple(torch.tensor(v) for v in vals), n)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    for g, w in zip(got_arr, want_arr):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_drain_check():
    class S:
        unplaced = torch.tensor(700)

    need, seen, ovf = tr.drain_check(S(), 0, 0, 16384, 10 ** 6, 1)
    assert (need, seen, ovf) == (False, 700, 0)     # 700 <= 16384 // 8
    need, seen, _ = tr.drain_check(S(), 0, 0, 4096, 10 ** 6, 1)
    assert need and seen == 700                      # 700 > 512
    S.overflow = torch.tensor([0, 3])
    with pytest.warns(RuntimeWarning, match="dropped"):
        need, _, ovf = tr.drain_check(S(), 700, 0, 16384, 10 ** 6, 1)
    assert need and ovf == 3


# -- layouts --------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_reserve_spread_layouts_match_reference(dim):
    """tile_id, validity and n_valid exactly, each tile segment as a set of
    rows; every tile keeps a dead slot, and with spread no dead block is
    left trailing.  The particles leave some tiles empty and put exactly a
    block into another (the cases reserve exists for)."""
    rng = np.random.default_rng(3 + dim)
    if dim == 2:
        shape = (32, 32)
        jt, tt = jsd.Tiling2D(8, 8, 64, 2), tsd.Tiling2D(8, 8, 64, 2)
    else:
        shape = (16, 16, 16)
        jt, tt = (jsd.Tiling3D((8, 8, 8), 64, 2),
                  tsd.Tiling3D((8, 8, 8), 64, 2))
    n_tiles = int(np.prod(tt.n_tiles(shape)))
    pos = (rng.random((1024, dim)) * np.array(shape) * 0.5).astype(
        np.float32)                               # the far tiles stay empty
    pos[:64] = 0.5                                # tile 0: exactly a block
    pos = pos[np.argsort(rng.random(1024))]
    vel = rng.standard_normal((1024, dim)).astype(np.float32)
    valid = rng.random(1024) < 0.9
    for kw in (dict(reserve=True), dict(reserve=True, spread=True),
               dict(spread=True)):
        want = jsd.build_padded_layout(
            jnp.asarray(pos), shape, jt, jnp.asarray(vel),
            valid=jnp.asarray(valid), derive_valid=True, **kw)
        got = tsd.build_padded_layout(
            torch.tensor(pos), shape, tt, torch.tensor(vel),
            valid=torch.tensor(valid), derive_valid=True, **kw)
        tid = np.asarray(want[0])
        np.testing.assert_array_equal(got[0].numpy(), tid)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert int(got[4]) == int(want[4])
        rows_j = np.concatenate([np.asarray(want[1]), np.asarray(want[2])], 1)
        rows_t = torch.cat([got[1], got[2]], 1).numpy()
        seg_j, seg_t = _segments(tid, rows_j), _segments(tid, rows_t)
        assert seg_j.keys() == seg_t.keys()
        for t in seg_j:
            np.testing.assert_array_equal(seg_t[t], seg_j[t])
        dead = ~got[3].numpy()
        if kw.get("reserve"):
            assert all(dead[tid == t].any() for t in range(n_tiles))
        if kw.get("spread"):
            # trailing: the invalid rows and less than a block of fillers
            assert (tid == n_tiles).sum() < (~valid).sum() + jt.block


def test_sort_by_tile_matches_reference():
    """Tile ids exactly, each tile's rows (position and payloads) as sets."""
    rng = np.random.default_rng(6)
    pos = (rng.random((300, 2)) * 32).astype(np.float32)
    w = rng.random(300).astype(np.float32)
    vel = rng.standard_normal((300, 2)).astype(np.float32)
    jt, tt = jsd.Tiling2D(8, 8, 64, 2), tsd.Tiling2D(8, 8, 64, 2)
    want = jsd.sort_by_tile(jnp.asarray(pos), (32, 32), jt, jnp.asarray(w),
                            jnp.asarray(vel))
    got = tsd.sort_by_tile(torch.tensor(pos), (32, 32), tt, torch.tensor(w),
                           torch.tensor(vel))
    tid = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), tid)
    rows_j = np.column_stack([np.asarray(want[1]), np.asarray(want[2]),
                              np.asarray(want[3])])
    rows_t = np.column_stack([got[1].numpy(), got[2].numpy(),
                              got[3].numpy()])
    seg_j, seg_t = _segments(tid, rows_j), _segments(tid, rows_t)
    for t in seg_j:
        np.testing.assert_array_equal(seg_t[t], seg_j[t])


# -- ES -------------------------------------------------------------------------

def _es_setup(n, cells, dim=2, seed=0, drift=0.6):
    """tests/test_repair.py's setup: thermal plus a steady drift, so tiles
    churn and rows spill."""
    length = 2 * np.pi
    d = length / cells
    vol = length ** dim
    kw = dict(grid_shape=(cells,) * dim, cell_size=(d,) * dim, dt=0.05,
              charge=-vol / n, mass=vol / n)
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, dim)) * cells).astype(np.float32)
    vel = (0.1 * rng.standard_normal((n, dim))).astype(np.float32)
    vel[:, 0] += drift
    return kw, pos, vel


def _es_pair(kw, pos, vel, tile, **args):
    dim = len(kw["grid_shape"])
    jt = jsd.Tiling2D(**tile) if dim == 2 else jsd.Tiling3D(**tile)
    tt = tsd.Tiling2D(**tile) if dim == 2 else tsd.Tiling3D(**tile)
    ref = jes.SortedElectrostaticPIC(jes.ESConfig(**kw), pos, vel,
                                     tiling=jt, **args)
    port = tes.SortedElectrostaticPIC.from_state(
        tes.ESConfig(**kw), _carry(ref.state), tiling=tt, device="cpu",
        **args)
    return ref, port


def _same_layout_and_rows(ref_state, port_state, tol=2e-5):
    """Validity, tile ids and free stacks exactly; every valid row's
    position and velocity to f32 rounding over a few steps."""
    valid = np.asarray(ref_state.valid)
    np.testing.assert_array_equal(port_state.valid.numpy(), valid)
    np.testing.assert_array_equal(port_state.tile_id.numpy(),
                                  np.asarray(ref_state.tile_id))
    for name in ("free_idx", "free_cnt", "unplaced"):
        np.testing.assert_array_equal(_np(getattr(port_state, name)),
                                      np.asarray(getattr(ref_state, name)))
    for name in ("position", "velocity"):
        want = np.asarray(getattr(ref_state, name))[valid]
        got = getattr(port_state, name).numpy()[valid]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("backend,eager", [("xla", 0), ("xla", 1),
                                           ("pallas", 0), ("pallas", 1)])
def test_es_repair_matches_reference_row_for_row(backend, eager):
    """repair=True with the resort disabled, from the reference's layout:
    the same rows spill, relocate into the same slots and leave the same
    stacks, step by step (row for row).  Without eager the drift spills
    rows past margin 1; with eager every band row moves before it exits,
    so nothing spills."""
    kw, pos, vel = _es_setup(2048, 32, drift=1.2)
    ref, port = _es_pair(kw, pos, vel,
                         dict(tile_r=8, tile_z=8, block=128, margin=1),
                         resort_every=10 ** 6, backend=backend, repair=True,
                         repair_eager=eager, check_spill=False)
    start = port.state.valid.clone()
    for _ in range(5):
        ref.step(1)
        port.step(1)
        assert port.state.spill == int(ref.state.spill)
        _same_layout_and_rows(ref.state, port.state)
    assert (port.state.spill > 0) == (not eager)
    assert int(port.state.spill_dropped) == 0
    assert int(port.state.valid.sum()) == pos.shape[0]
    assert not torch.equal(port.state.valid, start)   # the relocation ran


def test_es_xla_backend_and_3d_eager_match_reference():
    """ES backend='xla' without repair across a resort (2D, 3D; row for
    row up to the resort, then per tile segment as sets) and 3D eager
    repair on both backends (row for row)."""
    kw, pos, vel = _es_setup(1024, 16, drift=0.0)
    tile = dict(tile_r=8, tile_z=8, block=128, margin=1)
    ref, port = _es_pair(kw, pos, 60 * vel, tile, resort_every=3,
                         backend="xla", spill_capacity=512,
                         spill_tiers=(16,), check_spill=False)
    ref.step(2)
    port.step(2)
    assert port.state.spill == int(ref.state.spill)
    _same_layout_rows_only(ref.state, port.state)
    ref.step(2)                       # a step, the resort, a step
    port.step(2)
    assert port.state.spill == int(ref.state.spill) > 0
    _same_sets(ref.state, port.state)
    e_r, e_p = ref.energies(), port.energies()
    for key in ("kinetic", "field"):
        np.testing.assert_allclose(e_p[key], e_r[key], rtol=1e-4)

    kw, pos, vel = _es_setup(1024, 16, dim=3, seed=5)
    tile = dict(tile=(8, 8, 8), block=128, margin=1)
    for backend in ("xla", "pallas"):
        ref, port = _es_pair(kw, pos, vel, tile, resort_every=10 ** 6,
                             backend=backend, repair=True, repair_eager=1,
                             check_spill=False)
        ref.step(4)
        port.step(4)
        assert port.state.spill == int(ref.state.spill) == 0
        _same_layout_and_rows(ref.state, port.state)


def _same_layout_rows_only(ref_state, port_state):
    valid = np.asarray(ref_state.valid)
    np.testing.assert_array_equal(port_state.valid.numpy(), valid)
    np.testing.assert_allclose(port_state.position.numpy()[valid],
                               np.asarray(ref_state.position)[valid],
                               rtol=0, atol=2e-5 * 16)


def _same_sets(ref_state, port_state):
    tid = np.asarray(ref_state.tile_id)
    np.testing.assert_array_equal(port_state.tile_id.numpy(), tid)
    np.testing.assert_array_equal(port_state.valid.numpy(),
                                  np.asarray(ref_state.valid))
    rows = [np.concatenate([np.asarray(s.position), np.asarray(s.velocity)],
                           1) for s in (ref_state, port_state)]
    rows[1] = np.concatenate([port_state.position.numpy(),
                              port_state.velocity.numpy()], 1)
    seg_r, seg_p = _segments(tid, rows[0]), _segments(tid, rows[1])
    for t in seg_r:
        np.testing.assert_allclose(seg_p[t], seg_r[t], rtol=0, atol=1e-3)


def test_es_repair_auto_resort_on_exhaustion():
    """tests/test_repair.py's case: stacks of 8 slots drain under a strong
    drift, unplaced grows, the shell resorts on its own (at a call's
    start) and the run still tracks the plain reference model."""
    kw, pos, vel = _es_setup(2048, 64, drift=2.5)
    sim = tes.SortedElectrostaticPIC(
        tes.ESConfig(**kw), pos, vel,
        tiling=tsd.Tiling2D(16, 16, 256, margin=1), resort_every=10 ** 6,
        backend="xla", repair=True, repair_free_slots=8, check_spill=False,
        device="cpu")
    resorts = 0
    for _ in range(16):
        resorts += sim._need_resort
        sim.step(1)
    assert int(sim.state.unplaced) > 0 and resorts > 0
    assert int(sim.state.valid.sum()) == pos.shape[0]
    ref = jes.ElectrostaticPIC(jes.ESConfig(**kw), pos, vel)
    ref.step(16)
    np.testing.assert_allclose(sim.energies()["kinetic"],
                               ref.energies()["kinetic"], rtol=5e-3)


# -- EM -------------------------------------------------------------------------

@pytest.mark.parametrize("backend,dim,eager", [
    ("xla", 2, 0), ("pallas", 2, 0), ("fused", 2, 1), ("fused", 3, 1)])
def test_em_repair_matches_reference_row_for_row(backend, dim, eager):
    """SortedElectromagneticPIC(repair=True) with the resort disabled, from
    the reference's layout, on every gather backend: relocations, stacks
    and rows as the reference's (row for row), E and B to 1e-5 of their
    scale."""
    n, cells = (2048, 32) if dim == 2 else (1024, 16)
    cfg = dict(grid_shape=(cells,) * dim, cell_size=(0.5,) * dim, dt=0.1,
               charge=-0.01, mass=0.01, field_gather="centered")
    rng = np.random.default_rng(dim)
    pos = (rng.random((n, dim)) * cells).astype(np.float32)
    vel = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    vel[:, 0] += 2.5                      # 0.5 cells a step: tiles churn
    if dim == 2:
        tile = dict(tile_r=8, tile_z=8, block=128, margin=1)
        jt, tt = jsd.Tiling2D(**tile), tsd.Tiling2D(**tile)
    else:
        tile = dict(tile=(8, 8, 8), block=128, margin=1)
        jt, tt = jsd.Tiling3D(**tile), tsd.Tiling3D(**tile)
    args = dict(resort_every=10 ** 6, gather_backend=backend, repair=True,
                repair_eager=eager, check_spill=False)
    ref = jem.SortedElectromagneticPIC(jem.EMConfig(**cfg), pos, vel,
                                       tiling=jt, **args)
    port = tem.SortedElectromagneticPIC.from_state(
        tem.EMConfig(**cfg), _carry(ref.state), tiling=tt, device="cpu",
        **args)
    start = np.asarray(ref.state.valid)
    for _ in range(4):
        ref.step(1)
        port.step(1)
        assert port.state.spill == int(ref.state.spill)
        _same_layout_and_rows(ref.state, port.state)
    for name in ("e", "b"):
        want = np.asarray(getattr(ref.state, name))
        np.testing.assert_allclose(getattr(port.state, name).numpy(), want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())
    assert not np.array_equal(port.state.valid.numpy(), start)  # rows moved
    assert int(port.state.valid.sum()) == n
    if not eager:
        assert port.state.spill > 0


# -- pusher ---------------------------------------------------------------------

PUSHER_SPEC = {"radius": 1.0, "height": 2.0, "nr": 32, "nz": 64, "dt": 2e-9,
               "nparticles": 32, "particle_mass": 1.67e-27,
               "particle_charge": 1.602e-19}


@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_pusher_repair_matches_reference_row_for_row(backend):
    """The reference's xla sorted step with repair (resort off) is the
    oracle of every port backend on the reference's own uniforms: validity,
    stacks and unplaced exactly, rows to f32 rounding, respawns included."""
    from fusion_sim_torch.models import pusher as tpm
    from fusion_sim_torch.models import pusher_sorted as tps
    from fusion_sim_torch.scenarios import apply_default_scenario as t_apply
    from fusion_sim_tpu.models import pusher as jpm
    from fusion_sim_tpu.ops.rng import substep_uniforms
    from fusion_sim_tpu.scenarios import apply_default_scenario as j_apply

    ref = jpm.CylindricalParticlePusher(PUSHER_SPEC, seed=5)
    j_apply(ref, seed=5)
    rng = np.random.default_rng(0)
    n = ref.spec.n_total
    r = np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    ref.set({"position": np.stack([r * np.cos(th), r * np.sin(th),
                                   2 * rng.random(n)], -1),
             "velocity": 0.02 * rng.standard_normal((n, 3))})
    tile = dict(tile_r=8, tile_z=16, block=128, margin=2)
    ref.enable_sorted_path(tiling=jsd.Tiling2D(**tile), resort_every=10 ** 6,
                           spill_capacity=256, repair=True)
    _, fields = tpm.pusher_state_from_numpy(ref.get_state(), "cpu")
    step = tps.make_sorted_step_fn(tpm.PusherSpec(**PUSHER_SPEC),
                                   tsd.Tiling2D(**tile), 256, backend,
                                   repair=True)
    state = tps.sorted_pusher_state_from_numpy(_carry(ref._sorted_state),
                                               "cpu")
    st_r = ref._sorted_state
    start = np.asarray(st_r.valid)
    for _ in range(3):
        r1, key = substep_uniforms(st_r.key, st_r.position.shape[0])
        r2, _ = substep_uniforms(key, st_r.position.shape[0])
        st_r = ref._sorted_step(ref.fields, st_r)
        state = step(fields, state, [torch.tensor(np.asarray(x))
                                     for x in (r1, r2)])
        valid = np.asarray(st_r.valid)
        np.testing.assert_array_equal(state.valid.numpy(), valid)
        for name in ("free_idx", "free_cnt", "unplaced"):
            np.testing.assert_array_equal(_np(getattr(state, name)),
                                          np.asarray(getattr(st_r, name)))
        np.testing.assert_array_equal(state.alive.numpy(),
                                      np.asarray(st_r.alive))
        for name in ("position", "velocity"):
            np.testing.assert_allclose(
                getattr(state, name).numpy(), np.asarray(getattr(st_r, name)),
                rtol=1e-5, atol=1e-6)
    assert (np.asarray(st_r.alive) == 0).any()           # respawns happened
    assert (valid != start).sum() > 100                  # rows relocated
    assert state.dropped == int(st_r.dropped) == 0

    # the shell: enable_sorted_path(repair=True) with the drain check
    port = tpm.CylindricalParticlePusher(PUSHER_SPEC, seed=5, device="cpu")
    t_apply(port, seed=5)
    port.enable_sorted_path(tiling=tsd.Tiling2D(**tile), resort_every=10 ** 6,
                            backend=backend, repair=True,
                            repair_free_slots=64)
    for _ in range(4):
        port.step(1)
    st = port._sorted_state
    assert int(st.valid.sum()) == n and st.dropped == 0
    assert int(st.unplaced) <= max(1, st.spill)
    port.disable_sorted_path()
    assert port.state.position.shape == (n, 3)
