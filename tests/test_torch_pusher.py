"""Port vs reference: the cylindrical pusher, the slice as a whole.

The shells are built from the same spec and scenario; trajectories start
from the reference's carried state (``get_state`` / ``_sorted_state``) and
replay the reference's own uniforms (``substep_uniforms`` on its key, twice
a step), so they compare row for row with respawns included.  The JAX
``backend='xla'`` sorted model is the multi-step oracle of every port
backend (the JAX tests hold its fused backend to it); the JAX interpret
kernels are held at the op level (tests/test_torch_fused_pusher.py,
tests/test_torch_sorted_gather.py)."""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import pusher as tpm
from fusion_sim_torch.models import pusher_sorted as tps
from fusion_sim_torch.ops.boris import pack_coefficients
from fusion_sim_torch.ops.fused_pusher import fused_pusher_substep
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_torch.scenarios import DEFAULT_SPEC as T_DEFAULT
from fusion_sim_torch.scenarios import apply_default_scenario as t_apply
from fusion_sim_torch.scenarios import default_scenario_arrays as t_arrays
from fusion_sim_tpu.models import pusher as jpm
from fusion_sim_tpu.models.pusher_sorted import Tiling2D as JTiling
from fusion_sim_tpu.ops.rng import substep_uniforms as j_uniforms
from fusion_sim_tpu.scenarios import DEFAULT_SPEC as J_DEFAULT
from fusion_sim_tpu.scenarios import apply_default_scenario as j_apply
from fusion_sim_tpu.scenarios import default_scenario_arrays as j_arrays

SPEC = {"radius": 1.0, "height": 2.0, "nr": 32, "nz": 64, "dt": 2e-9,
        "nparticles": 32, "particle_mass": 1.67e-27,
        "particle_charge": 1.602e-19}
TILE = dict(tile_r=8, tile_z=16, block=128, margin=2)
# f32 trajectories over a few steps: the coefficient gathers select the
# same f32 values, the rotations round alike up to XLA's FMA contraction
RTOL, ATOL = 1e-5, 1e-6


def _pair(loop_field_mode="table", seed=5):
    ref = jpm.CylindricalParticlePusher(SPEC, seed=seed,
                                        loop_field_mode=loop_field_mode)
    port = tpm.CylindricalParticlePusher(SPEC, seed=seed,
                                         loop_field_mode=loop_field_mode,
                                         device="cpu")
    return ref, port


def _spread_out(sims, seed=0, vscale=0.02):
    """Particles over the whole cylinder with fast velocities: every
    substep some leave their windows and some are absorbed at the walls."""
    rng = np.random.default_rng(seed)
    n = SPEC["nparticles"] ** 2
    r = np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th), 2 * rng.random(n)], -1)
    vel = vscale * rng.standard_normal((n, 3))
    for sim in sims:
        sim.set({"position": pos, "velocity": vel})


def _carry_sorted(ref):
    return tps.sorted_pusher_state_from_numpy(
        {k: np.asarray(v) for k, v in ref._sorted_state._asdict().items()
         if v is not None and k != "key"}, "cpu")


def _two_uniforms(key, n):
    r1, key = j_uniforms(key, n)
    r2, _ = j_uniforms(key, n)
    return [torch.tensor(np.asarray(r)) for r in (r1, r2)]


def _close(got, ref, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **(kw or dict(rtol=RTOL, atol=ATOL)))


def test_default_scenario_matches_reference():
    assert T_DEFAULT == J_DEFAULT
    small = dict(nr=16, nz=24, nparticles=8, height=2.0)
    for key, value in j_arrays(small, seed=3).items():
        np.testing.assert_array_equal(t_arrays(small, seed=3)[key], value)


@pytest.mark.parametrize("loop_field_mode", ["table", "exact"])
def test_shell_setup_matches_reference(loop_field_mode):
    """set, both loop modes, add_current_z/bz/btheta, precalc."""
    ref, port = _pair(loop_field_mode)
    e = np.random.default_rng(1).standard_normal((32, 64, 3)) * 1e3
    for sim, apply in ((ref, j_apply), (port, t_apply)):
        apply(sim, seed=5)
        sim.add_current_z(2e4)
        sim.add_bz(0.05)
        sim.add_btheta(-0.02)
        sim.set({"E": e})
        sim.precalc()
    got, want = port.get_state(), ref.get_state()
    for key in ("state.position", "state.velocity", "state.alive",
                "fields.e", "fields.sink_mask", "fields.inv_cdf"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the table mode's quadrature tables drift ~6e-5 of their scale apart
    # (tests/test_torch_pusher_ops.py); the exact mode is f32 arithmetic
    rel = 2e-4 if loop_field_mode == "table" else 1e-5
    for key in ("fields.b", "fields.coeffs.r1", "fields.coeffs.r2",
                "fields.coeffs.r3", "fields.coeffs.a"):
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=rel * scale, err_msg=key)


def test_plain_step_and_density_match_reference():
    """The grid-parity path from the reference's carried state, replaying
    its uniforms; an absorbing core forces respawns every substep."""
    ref, port = _pair()
    j_apply(ref, seed=5)
    sink = np.asarray(ref.fields.sink_mask).copy()
    sink[:6, 24:40] = 0.0
    ref.set({"sink_mask": sink})
    port.set_state(ref.get_state())
    step = tpm.make_step_fn(port.spec)
    state, key = port.state, ref.state.key
    respawned = 0
    for _ in range(3):
        rands = _two_uniforms(key, port.spec.n_total)
        ref.step(1)
        key = ref.state.key
        state = step(port.fields, state, rands)
        respawned += int((np.asarray(ref.state.alive) == 0).sum())
        _close(state.position, ref.state.position)
        _close(state.velocity, ref.state.velocity)
        np.testing.assert_array_equal(state.alive.numpy(),
                                      np.asarray(ref.state.alive))
    assert respawned > 20, "needs respawns"
    port.state = state
    frame_r, frame_p = np.asarray(ref.density()), port.density()
    assert frame_p.shape == (32, 64, 3)
    np.testing.assert_allclose(frame_p.numpy(), frame_r, rtol=1e-5,
                               atol=1e-5 * np.abs(frame_r).max())


def test_get_state_set_state_round_trip():
    """The port's own checkpoint, generator state included: a restored
    shell continues bit for bit."""
    a = tpm.make_cylindrical_particle_pusher(SPEC, seed=2, device="cpu")
    t_apply(a, seed=2)
    a.step(1)
    b = tpm.CylindricalParticlePusher(SPEC, seed=9, device="cpu")
    b.set_state(a.get_state())
    a.step(2)
    b.step(2)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    run = tpm.make_multi_step_fn(b.spec, 2)
    gen_a = torch.Generator().manual_seed(4)
    gen_b = torch.Generator().manual_seed(4)
    s1 = run(b.fields, b.state, gen_a)
    s2 = b.state
    for _ in range(2):
        rands = [torch.rand((b.spec.n_total, 4), generator=gen_b)
                 for _ in range(2)]
        s2 = b._step(b.fields, s2, rands)
    for x, y in zip(s1, s2):
        assert torch.equal(x, y)


def _sorted_pair(backend, spill_capacity=256, seed=5):
    ref, port = _pair(seed=seed)
    j_apply(ref, seed=seed)
    _spread_out([ref])
    ref.enable_sorted_path(tiling=JTiling(**TILE), resort_every=10 ** 6,
                           spill_capacity=spill_capacity)
    _, fields = tpm.pusher_state_from_numpy(ref.get_state(), "cpu")
    step = tps.make_sorted_step_fn(port.spec, TTiling(**TILE),
                                   spill_capacity, backend)
    return ref, fields, _carry_sorted(ref), step


@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_sorted_backends_match_reference(backend):
    """Three steps without a resort from the reference's layout: rows,
    alive flags and counters as the reference's xla backend has them.
    The fused backend counts a row once a substep whichever of its two
    samples left the window (the reference's fused counter), so its
    ``spill`` is checked against its kernel's own in_win instead."""
    ref, fields, state, step = _sorted_pair(backend)
    st_r = ref._sorted_state
    n_rows = st_r.position.shape[0]
    packed = torch.cat([pack_coefficients(fields.coeffs),
                        fields.sink_mask[..., None]], -1)
    spill_fused = 0
    for _ in range(3):
        rands = _two_uniforms(st_r.key, n_rows)
        st_r = ref._sorted_step(ref.fields, st_r)
        for rand in rands:                 # the step's two half-steps
            inw = fused_pusher_substep(
                packed, state.position, state.velocity, state.alive, rand,
                state.tile_id, 32, 64, TTiling(**TILE),
                ref.spec.step_factor)[3]
            spill_fused += int((~inw & state.valid).sum())
            state = step(fields, state, [rand])
        _close(state.position, st_r.position)
        _close(state.velocity, st_r.velocity)
        np.testing.assert_array_equal(state.alive.numpy(),
                                      np.asarray(st_r.alive))
        assert state.dropped == int(st_r.dropped)
        assert state.dropped_over == int(st_r.dropped_over) == 0
        if backend != "fused":
            assert state.spill == int(st_r.spill)
    assert int(st_r.spill) > 300, "needs spill"
    assert (np.asarray(st_r.alive) == 0).sum() > 0, "needs respawns"
    if backend == "fused":
        assert 0 < state.spill == spill_fused < int(st_r.spill)


def test_sorted_resort_window_matches_reference():
    """Two fused steps, then the resort, from the reference's layout: the
    layouts agree on tile ids and validity, and per tile segment as sets
    (the two sorts order rows inside a tile differently)."""
    ref, fields, state, step = _sorted_pair("fused")
    st_r = ref._sorted_state
    for _ in range(2):
        rands = _two_uniforms(st_r.key, st_r.position.shape[0])
        st_r = ref._sorted_step(ref.fields, st_r)
        state = step(fields, state, rands)
    st_r = ref._sorted_resort(st_r)
    state = tps.make_sorted_resort_fn(ref.spec, TTiling(**TILE))(state)
    tid = np.asarray(st_r.tile_id)
    np.testing.assert_array_equal(state.tile_id.numpy(), tid)
    np.testing.assert_array_equal(state.valid.numpy(), np.asarray(st_r.valid))
    rows_r = np.concatenate([np.asarray(st_r.position),
                             np.asarray(st_r.velocity),
                             np.asarray(st_r.alive)[:, None]], 1)
    rows_p = torch.cat([state.position, state.velocity,
                        state.alive[:, None]], 1).numpy()
    for t in np.unique(tid):
        seg = tid == t
        a = rows_p[seg][np.lexsort(rows_p[seg].T)]
        b = rows_r[seg][np.lexsort(rows_r[seg].T)]
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_sorted_density_matches_reference():
    ref, fields, state, _ = _sorted_pair("fused")
    st_r, frame_r = ref._sorted_density(ref.fields, ref._sorted_state)
    st_p, frame_p = tps.make_sorted_density_fn(ref.spec)(fields, state)
    scale = np.abs(np.asarray(frame_r)).max()
    np.testing.assert_allclose(frame_p.numpy(), np.asarray(frame_r),
                               rtol=1e-5, atol=1e-5 * scale)
    _close(st_p.moments_avg, st_r.moments_avg, rtol=1e-5,
           atol=1e-5 * np.abs(np.asarray(st_r.moments_avg)).max())


def test_spill_tiers_match_single_tier():
    _, fields, state, single = _sorted_pair("fused")
    tiered = tps.make_sorted_step_fn(tpm.PusherSpec(**SPEC), TTiling(**TILE),
                                     256, "fused", spill_tiers=(4, 32))
    gen = torch.Generator().manual_seed(0)
    a = b = state
    for _ in range(3):
        rands = [torch.rand((state.position.shape[0], 4), generator=gen)
                 for _ in range(2)]
        a = single(fields, a, rands)
        b = tiered(fields, b, rands)
    assert a.spill == b.spill > 0
    assert (a.dropped, a.dropped_over) == (b.dropped, b.dropped_over)
    for name in ("position", "velocity", "alive"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("backend", ["xla", "pallas", "fused"])
def test_spill_capacity_overflow_freezes_not_corrupts(backend):
    """tests/test_pusher_sorted.py's overflow case on the port: rows past
    ``spill_capacity`` freeze for the substep and retry.  With zero fields
    the velocity is constant, so after k steps every displacement is an
    integer number 0..2k of substep drifts, and the overflow shows in
    ``dropped_over``."""
    sim = tpm.CylindricalParticlePusher(dict(SPEC, nr=64, nz=128),
                                        device="cpu")
    rng = np.random.default_rng(7)
    n = sim.spec.n_total
    r = 0.2 + 0.5 * rng.random(n)
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th),
                    0.4 + 1.0 * rng.random(n)], axis=-1)
    sim.set({"position": pos, "velocity": 0.004 * rng.standard_normal(
        (n, 3))})
    pos0, vel0 = sim.state.position.numpy(), sim.state.velocity.numpy()
    sim.precalc()
    sim.enable_sorted_path(
        tiling=TTiling(tile_r=8, tile_z=8, block=128, margin=1),
        resort_every=10_000, spill_capacity=32, backend=backend)
    k = 6
    sim.step(k)
    st = sim._sorted_state
    assert st.dropped_over > 0 and st.dropped == 0
    valid = st.valid.numpy()
    p1, v1 = st.position.numpy()[valid], st.velocity.numpy()[valid]
    order1, order0 = np.lexsort(v1.T), np.lexsort(vel0.T)
    v_ref = vel0[order0]
    np.testing.assert_allclose(v1[order1], v_ref, rtol=1e-4, atol=1e-8)
    d = p1[order1] - pos0[order0]
    step_vec = np.float32(sim.spec.step_factor) * v_ref
    comp = np.argmax(np.abs(step_vec), axis=1)
    idx = np.arange(len(d))
    m = d[idx, comp] / step_vec[idx, comp]
    np.testing.assert_allclose(m, np.round(m), atol=2e-2)
    assert (np.round(m) >= 0).all() and (np.round(m) <= 2 * k).all()
    assert (np.round(m) < 2 * k).any()


def test_shell_sorted_path_matches_reference():
    """Shell to shell, tests/test_pusher_sorted.py's interior set-up (no
    sinks, so no respawns and no random numbers enter): the port's fused
    path with resorts against the reference's xla path, as multisets."""
    ref, port = _pair()
    rng = np.random.default_rng(1)
    n = SPEC["nparticles"] ** 2
    r = 0.3 + 0.3 * rng.random(n)
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th),
                    0.6 + 0.8 * rng.random(n)], axis=-1)
    vel = 0.002 * rng.standard_normal((n, 3))
    for sim, tiling in ((ref, JTiling(**TILE)), (port, TTiling(**TILE))):
        sim.set({"position": pos, "velocity": vel})
        sim.add_current_loop(0.8, 0.0, 1.0e7)
        sim.add_current_loop(0.8, 2.0, -1.0e7)
        sim.precalc()
    ref.enable_sorted_path(tiling=JTiling(**TILE), resort_every=3)
    port.set_state(ref.get_state())       # the reference's fields
    port.enable_sorted_path(tiling=TTiling(**TILE), resort_every=3,
                            backend="fused")
    ref.step(7)
    port.step(7)
    ref.disable_sorted_path()
    port.disable_sorted_path()
    pa = np.asarray(ref.state.position)
    pb = port.state.position.numpy()
    assert pb.shape == pa.shape
    d2 = ((pb[:, None, :] - pa[None, :, :]) ** 2).sum(-1)
    match = d2.argmin(axis=1)
    assert len(np.unique(match)) == len(match)
    np.testing.assert_allclose(pb, pa[match], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.state.velocity.numpy(),
                               np.asarray(ref.state.velocity)[match],
                               rtol=RTOL, atol=1e-7)


def test_not_ported_and_validation():
    port = tpm.CylindricalParticlePusher(SPEC, device="cpu")
    # the fast path, repair and the spindle field are ported
    # (tests/test_torch_analytic.py, tests/test_torch_repair.py,
    # tests/test_torch_spindle.py)
    port.add_bz(0.01)
    port.enable_fast_path()
    assert port._fast_scenario.bz == 0.01
    port.disable_fast_path()
    b0 = port.fields.b.clone()
    port.add_spindle_cusp_plasma_field(1e4, n_power=1)
    assert port._sources[-1] == ("spindle",)
    assert float((port.fields.b - b0).abs().max()) > 0
    with pytest.raises(ValueError, match="analytic sources"):
        port.enable_fast_path()
    port.enable_sorted_path(tiling=TTiling(**TILE), repair=True,
                            repair_free_slots=32)
    st = port._sorted_state
    assert st.free_idx.shape == (16, 32) and int(st.unplaced) == 0
    assert bool((st.free_cnt > 0).all())       # reserve: every tile has slots
    with pytest.raises(ValueError, match="backend"):
        port.enable_sorted_path(tiling=TTiling(**TILE), backend="mosaic")
    with pytest.raises(ValueError, match="spill_tiers"):
        port.enable_sorted_path(tiling=TTiling(**TILE), spill_capacity=64,
                                spill_tiers=(64,))
    with pytest.raises(ValueError, match="loop_field_mode"):
        tpm.CylindricalParticlePusher(SPEC, loop_field_mode="fast",
                                      device="cpu")
    with pytest.raises(Exception, match="nz"):
        tpm.CylindricalParticlePusher({k: v for k, v in SPEC.items()
                                       if k != "nz"}, device="cpu")
    # the default tilings: the fused kernel's streamed one, else 50 x 50
    big = tpm.CylindricalParticlePusher(dict(SPEC, nr=400, nz=800,
                                             nparticles=4),
                                        loop_field_mode="exact", device="cpu")
    big.enable_sorted_path(backend="fused", rng_impl="rbg")
    assert big._sorted_tiling == TTiling(8, 100, 1024, 6)
    big.enable_sorted_path(backend="pallas")
    assert big._sorted_tiling == TTiling(50, 50, 1024, 4)
    assert big._sorted_capacity == 4096
