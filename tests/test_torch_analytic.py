"""Port vs reference: the analytic fast path of the pusher
(``ops/analytic.py`` and ``CylindricalParticlePusher.enable_fast_path``),
modelled on tests/test_analytic.py.

The port's substep takes its uniforms as an argument; the comparisons
rebuild the reference's own draws from its key (``analytic.py:94-95``:
split, then a (N, 4) uniform), so rows compare one for one, respawns
included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.models import pusher as tpm
from fusion_sim_torch.ops import analytic as TA
from fusion_sim_torch.scenarios import apply_default_scenario as t_apply
from fusion_sim_tpu.models import pusher as jpm
from fusion_sim_tpu.ops import analytic as JA
from fusion_sim_tpu.scenarios import apply_default_scenario as j_apply

SPEC = {"radius": 1.0, "height": 2.0, "nr": 64, "nz": 128, "dt": 2e-9,
        "nparticles": 16, "particle_mass": 1.67e-27,
        "particle_charge": 1.602e-19}
PSPEC = dict(radius=1.0, height=2.0, nr=400, nz=800, dt=2e-9, nparticles=16,
             particle_mass=1.67e-27, particle_charge=1.602e-19)
# f32 closed forms in the same operation order; XLA on the CPU contracts
# some products into FMAs and has its own log/rsqrt.  Near the coils (|B| ~
# 50 T, a rotation of ~1 rad a substep) that reaches ~3e-6 of a row's
# velocity, so rows are held at 1e-5 of their own scale after one substep
# and 1e-4 after 24
RTOL = 1e-5


def _close_rows(got, want, tol):
    """|got - want| <= tol * max|want row| on every row."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= tol * scale).all(), \
        float((np.abs(got - want) / scale).max())


def _scenarios():
    plain = dict(loops=((0.8, 2.0, -1e7), (0.8, 0.0, 1e7)),
                 sink_box=(0.99, 0.02, 1.98), source_box=(0.0, 0.125, 0.875,
                                                          1.125),
                 axis_keep_r=1 / 400)
    rich = dict(plain, bz=0.02, btheta=-0.01, line_current=3e4,
                uniform_e=(2e3, 0.0, -1e3))
    return [plain, rich]


def _uniforms(key, n):
    """The reference's draw of one substep (and the next key)."""
    key, sub = jax.random.split(key)
    return key, jax.random.uniform(sub, (n, 4), dtype=jnp.float32)


def _particles(n, seed):
    """Positions over the cylinder (a third outside the sink box, so they
    respawn), fast velocities, every fifth row fresh (alive = 0)."""
    rng = np.random.default_rng(seed)
    r = 1.05 * np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th), 2.02 * rng.random(n)
                    - 0.01], -1) * np.array([1.0, 1.0, 0.5])
    vel = 0.003 * rng.standard_normal((n, 3))
    alive = np.where(np.arange(n) % 5 == 0, 0.0, 1.0)
    return [x.astype(np.float32) for x in (pos, vel, alive)]


def test_b_field_at_matches_reference():
    rng = np.random.default_rng(0)
    r = (1.2 * rng.random(512)).astype(np.float32)
    z = (2.0 * rng.random(512)).astype(np.float32)
    r[:4] = 0.0                                     # the on-axis limit
    for kw in _scenarios():
        ref = np.asarray(JA.b_field_at(JA.AnalyticScenario(**kw),
                                       jnp.asarray(r), jnp.asarray(z)))
        got = TA.b_field_at(TA.AnalyticScenario(**kw), torch.tensor(r),
                            torch.tensor(z)).numpy()
        for c in range(3):
            np.testing.assert_allclose(got[:, c], ref[:, c], rtol=RTOL,
                                       atol=1e-5 * np.abs(ref[:, c]).max())


@pytest.mark.parametrize("which", [0, 1])
def test_substep_matches_reference_on_the_same_uniforms(which):
    kw = _scenarios()[which]
    spec_j, spec_t = jpm.PusherSpec(**PSPEC), tpm.PusherSpec(**PSPEC)
    n = 1024
    pos, vel, alive = _particles(n, seed=which)
    key = jax.random.key(3)
    state_j = JA.FastState(jnp.asarray(pos), jnp.asarray(vel),
                           jnp.asarray(alive), key)
    out_j = JA._substep(spec_j, JA.AnalyticScenario(**kw), state_j)
    _, rand = _uniforms(key, n)
    out_t = TA._substep(spec_t, TA.AnalyticScenario(**kw),
                        TA.FastState(torch.tensor(pos), torch.tensor(vel),
                                     torch.tensor(alive)),
                        torch.tensor(np.asarray(rand)))
    alive_j = np.asarray(out_j.alive)
    assert 0 < alive_j.sum() < n                    # some rows respawned
    np.testing.assert_array_equal(out_t.alive.numpy(), alive_j)
    _close_rows(out_t.position.numpy(), out_j.position, RTOL)
    _close_rows(out_t.velocity.numpy(), out_j.velocity, RTOL)


def test_trajectory_matches_reference():
    """12 full steps of the JAX multi-step function against the port's
    substeps on the reference's uniforms; then the port's own multi-step
    function against the same loop on its generator."""
    kw = _scenarios()[1]
    spec_j, spec_t = jpm.PusherSpec(**PSPEC), tpm.PusherSpec(**PSPEC)
    n, steps = 512, 12
    pos, vel, alive = _particles(n, seed=7)
    # inside the sink box and away from the coils (whose ~50 T fields
    # amplify rounding step by step): a trajectory with few respawns
    pos[:, :2] *= 0.8
    pos[:, 2] = 0.25 + 0.5 * pos[:, 2]
    key = jax.random.key(11)
    out_j = JA.make_fast_multi_step_fn(spec_j, JA.AnalyticScenario(**kw),
                                       steps)(
        JA.FastState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
                     key))
    scen = TA.AnalyticScenario(**kw)
    st = TA.FastState(torch.tensor(pos), torch.tensor(vel),
                      torch.tensor(alive))
    for _ in range(2 * steps):
        key, rand = _uniforms(key, n)
        st = TA._substep(spec_t, scen, st, torch.tensor(np.asarray(rand)))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(out_j.alive))
    _close_rows(st.position.numpy(), out_j.position, 1e-4)
    _close_rows(st.velocity.numpy(), out_j.velocity, 1e-4)
    # the multi-step function is that loop on a generator's draws
    st0 = TA.FastState(torch.tensor(pos), torch.tensor(vel),
                       torch.tensor(alive))
    got = TA.make_fast_multi_step_fn(spec_t, scen, 3)(
        st0, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    want = st0
    for _ in range(6):
        want = TA._substep(spec_t, scen, want,
                           torch.rand((n, 4), generator=gen))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_shell_fast_path_matches_reference_scenario_and_validates():
    ref = jpm.CylindricalParticlePusher(SPEC, seed=0)
    port = tpm.CylindricalParticlePusher(SPEC, seed=0, device="cpu")
    j_apply(ref)
    t_apply(port)
    for sim in (ref, port):
        sim.add_bz(0.01)
        sim.add_btheta(-0.02)
        sim.add_current_z(1e4)
    assert port._sources == ref._sources
    ref.enable_fast_path()
    port.enable_fast_path()
    assert (dataclass_fields(port._fast_scenario)
            == dataclass_fields(ref._fast_scenario))
    # the shell steps on the fast path: positions carried, rows respawned
    # inside the source box (the default scenario's cusp loses particles)
    before = port.state.position.clone()
    port.step(3)
    assert not torch.equal(port.state.position, before)
    assert bool(torch.isfinite(port.state.position).all())
    port.disable_fast_path()
    assert port._fast_scenario is None

    # every ValueError of the reference, and the spindle source is refused
    grid_b = tpm.CylindricalParticlePusher(SPEC, device="cpu")
    grid_b.set({"B": np.zeros((64, 128, 3), np.float32)})
    with pytest.raises(ValueError, match="grid B"):
        grid_b.enable_fast_path()
    grid_e = tpm.CylindricalParticlePusher(SPEC, device="cpu")
    grid_e.set({"E": np.zeros((64, 128, 3), np.float32)})
    with pytest.raises(ValueError, match="grid E"):
        grid_e.enable_fast_path()
    grid_e.enable_fast_path(uniform_e=(1.0, 0.0, 0.0))
    assert grid_e._fast_scenario.uniform_e == (1.0, 0.0, 0.0)
    other = tpm.CylindricalParticlePusher(SPEC, device="cpu")
    other._sources.append(("spindle",))
    with pytest.raises(ValueError, match="analytic sources"):
        other.enable_fast_path()
    # the spindle field is added to B (tests/test_torch_spindle.py holds it
    # against the reference) and recorded, so the fast path refuses it
    spindle = tpm.CylindricalParticlePusher(SPEC, device="cpu")
    b0 = spindle.fields.b.clone()
    spindle.add_spindle_cusp_plasma_field(1e4, n_power=1)
    assert spindle._sources == [("spindle",)]
    assert bool(torch.isfinite(spindle.fields.b).all())
    assert float((spindle.fields.b - b0).abs().max()) > 0
    with pytest.raises(ValueError, match="analytic sources"):
        spindle.enable_fast_path()


def dataclass_fields(scen):
    return tuple(getattr(scen, f) for f in ("loops", "bz", "btheta",
                                            "line_current", "uniform_e",
                                            "sink_box", "source_box",
                                            "axis_keep_r"))


def test_fast_path_matches_grid_on_uniform_field():
    """With a uniform B the NEAREST grid sample and the closed form see the
    same field, so the port's grid and fast paths agree on one stream."""
    sims = [tpm.CylindricalParticlePusher(SPEC, seed=5, device="cpu")
            for _ in range(2)]
    rng = np.random.default_rng(0)
    n = SPEC["nparticles"] ** 2
    init = {"position": 0.2 * (rng.random((n, 3)) - 0.5) + [0, 0, 1.0],
            "velocity": 0.002 * (rng.random((n, 3)) - 0.5),
            "source_pdf": np.ones((64, 128), np.float32)}
    for s in sims:
        s.set(init)
        s.add_bz(0.05)
        s.precalc()
    sims[1].enable_fast_path(rng_impl=None)   # keep the stream
    for s in sims:
        s.step(20)
    np.testing.assert_allclose(sims[1].state.position.numpy(),
                               sims[0].state.position.numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(sims[1].state.velocity.numpy(),
                               sims[0].state.velocity.numpy(), rtol=2e-5,
                               atol=2e-7)


def test_fast_path_respawn_geometry():
    sim = tpm.CylindricalParticlePusher(SPEC, seed=7, device="cpu")
    sim.add_bz(0.01)
    sim.enable_fast_path(sink_box=(0.9, 0.1, 1.9),
                         source_box=(0.0, 0.2, 0.8, 1.2))
    n = SPEC["nparticles"] ** 2
    sim.state = sim.state._replace(position=torch.tensor(
        [[0.95, 0.0, 0.5]]).repeat(n, 1))           # all outside the box
    sim.step()
    pos = sim.state.position.numpy()
    r = np.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2)
    assert (r <= 0.2 + 1e-3).all()
    assert ((pos[:, 2] * 2.0 >= 0.8 - 1e-3)
            & (pos[:, 2] * 2.0 <= 1.2 + 1e-3)).all()
    speed = np.linalg.norm(sim.state.velocity.numpy(), axis=1)
    assert speed.max() <= 0.001 * np.sqrt(3) + 1e-6


def _drift_state(n, seed, pos_fn):
    rng = np.random.default_rng(seed)
    scale = np.array([1.0, 1.0, 0.5])
    pos, v_phys = pos_fn(rng, n)
    st = TA.FastState(torch.tensor(pos * scale, dtype=torch.float32),
                      torch.tensor(v_phys * scale, dtype=torch.float32),
                      torch.ones(n))
    return st, v_phys, scale


def test_energy_conservation():
    """Mirror-field pusher without sinks: every particle's physical speed
    kept to < 1e-3 over 2,000 substeps (the drift bar of bench.py, whose
    10,000 substeps run on the card in chip_smoke.py)."""
    spec = tpm.PusherSpec(**PSPEC)
    scen = TA.AnalyticScenario(loops=((0.8, 2.0, -1e7), (0.8, 0.0, 1e7)),
                               sink_box=(10.0, -10.0, 10.0),
                               source_box=(0.0, 0.1, 0.9, 1.1))

    def init(rng, n):
        return ((0.3 * rng.random((n, 3)) + 0.1) / [1, 1, 0.5]
                + [0, 0, 0.8], 0.002 * (rng.random((n, 3)) - 0.5))

    st, v_phys, scale = _drift_state(256, 1, init)
    out = TA.make_fast_multi_step_fn(spec, scen, 1000)(
        st, torch.Generator().manual_seed(2))
    assert float(out.alive.min()) == 1.0
    v0 = np.linalg.norm(v_phys, axis=1)
    v1 = np.linalg.norm(out.velocity.numpy() / scale, axis=1)
    assert (np.abs(v1 - v0) / v0).max() < 1e-3


def test_magnetic_mirror_bounce():
    """Co-directed coils (a true mirror, ratio ~2.15): near-axis protons
    with v_perp >> v_par bounce between the throats, never reach the coils
    and keep their speed (tests/test_analytic.py's oracle, 6,000 substeps).
    """
    spec = tpm.PusherSpec(**dict(PSPEC, nparticles=4))
    scen = TA.AnalyticScenario(loops=((0.8, 2.0, 1e7), (0.8, 0.0, 1e7)),
                               sink_box=(10.0, -10.0, 10.0),
                               source_box=(0.0, 0.1, 0.9, 1.1))

    def init(rng, n):
        pos = np.zeros((n, 3))
        pos[:, 0] = 0.05 + 0.01 * rng.random(n)
        pos[:, 2] = 1.0
        v = np.zeros((n, 3))
        v[:, 1] = 0.002
        v[:, 2] = 0.0005
        return pos, v

    st, v, scale = _drift_state(16, 3, init)
    run = TA.make_fast_multi_step_fn(spec, scen, 250)
    gen = torch.Generator().manual_seed(0)
    z_hist, vz_hist = [], []
    for _ in range(12):
        st = run(st, gen)
        z_hist.append(st.position[:, 2].numpy() * 2.0)
        vz_hist.append(st.velocity[:, 2].numpy())
    z_hist, vz_hist = np.array(z_hist), np.array(vz_hist)
    assert z_hist.min() > 0.2 and z_hist.max() < 1.8
    sign_changes = (np.diff(np.sign(vz_hist), axis=0) != 0).sum(axis=0)
    assert (sign_changes >= 2).mean() > 0.8, sign_changes
    v1 = np.linalg.norm(st.velocity.numpy() / scale, axis=1)
    np.testing.assert_allclose(v1, np.linalg.norm(v, axis=1), rtol=2e-3)
