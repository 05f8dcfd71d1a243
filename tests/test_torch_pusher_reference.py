"""The benchmark's plain reference of an app frame
(``port_bench/reference/pusher.py``) against the port and against the
JAX package, on the CPU.

A frame is the app's: two half-steps, then ``density()``.  Both sides
start from one state and take the same uniforms, so rows compare one for
one, respawns included.  The loads are seeded and fast (rows leave their
windows and reach the walls in the first frames) at 16^2 protons on
32 x 64 cells.

Tolerances.  The reference builds B in float64 where the app's tables
(and the port's and the JAX package's) sum in float32; on this grid the
two differ by up to 1.3e-5 of the largest |B|, at the cell beside a
loop, and by 3.4e-7 in h |B| where the rows move.  A half-step's
rotation moves a velocity by that much of itself, and the drift moves a
position by dt c times the velocity's change: positions agree to 1e-6
(normalized, ~3e-5 of a cell here), velocities to 1e-5 of their
largest.  The average's count channel and the frame's change carry no B
and agree to float32 rounding of their sums (1e-5 of the largest); the
frame itself holds the |B| layer, 3e-5 of its largest.  The JAX package's
tables drift ~6e-5 of their scale from the port's
(tests/test_torch_pusher.py), and XLA contracts the rotation into fused
multiply-adds: its velocities and frame agree to 1e-4 of their largest
(2e-5 and 1.7e-5 read on three seeds).
"""

import numpy as np
import pytest
import torch

from fusion_sim_torch.models import pusher as tpm
from fusion_sim_torch.models import pusher_sorted as tps
from fusion_sim_torch.ops.fused_pusher import stream_tiling_for
from fusion_sim_torch.ops.rng import substep_uniforms
from fusion_sim_torch.scenarios import apply_default_scenario
from port_bench.reference import pusher as ref
from torch_ranks import one_torch_thread  # noqa: F401

SPEC = {"radius": 1.0, "height": 2.0, "nr": 32, "nz": 64, "dt": 2e-9,
        "nparticles": 16, "particle_mass": 1.67e-27,
        "particle_charge": 1.602e-19}
PHYS = {"grid_shape": [32, 64], "radius": 1.0, "height": 2.0, "dt": 2e-9,
        "particle_mass": 1.67e-27, "particle_charge": 1.602e-19,
        "coils": [[0.8, 2.0, -1e7], [0.8, 0.0, 1e7]], "sinks": "walls",
        "source_box": [0.0, 0.125, 0.4375, 0.5625]}
FRAMES = 3
POS_ATOL = 1e-6
VEL_RTOL = 1e-5
AVG_RTOL = 1e-5
FRAME_RTOL = 3e-5
JAX_RTOL = 1e-4


def _load(seed: int):
    """Positions over the whole vessel in metres, velocities of ~0.02 c:
    each frame some rows leave their windows and some reach a wall."""
    rng = np.random.default_rng(seed)
    n = SPEC["nparticles"] ** 2
    r = np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th), 2 * rng.random(n)], -1)
    vel = 0.02 * rng.standard_normal((n, 3))
    return pos, vel


def _port(seed: int):
    sim = tpm.CylindricalParticlePusher(SPEC, seed=seed, device="cpu")
    apply_default_scenario(sim, seed=seed)
    pos, vel = _load(seed)
    sim.set({"position": pos, "velocity": vel})
    return sim


def _scaled(t, scale):
    return (t.abs().max() * scale).item()


def _compare_rows(got, want, vel_rtol=VEL_RTOL):
    pos, vel, alive = got
    np.testing.assert_allclose(pos.numpy(), want["pos"].numpy(), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(vel.numpy(), want["vel"].numpy(), rtol=0,
                               atol=_scaled(want["vel"], vel_rtol))
    np.testing.assert_array_equal(alive.numpy(), want["alive"].numpy())


def _compare_grids(avg, frame, want, frame_rtol=FRAME_RTOL):
    np.testing.assert_allclose(avg[..., 3].numpy(),
                               want["avg"][..., 3].numpy(), rtol=0,
                               atol=_scaled(want["avg"][..., 3], AVG_RTOL))
    counted = want["count"] >= 1e-12 * want["count"].max()
    np.testing.assert_allclose(avg[counted][:, :3].numpy(),
                               want["avg"][counted][:, :3].numpy(), rtol=0,
                               atol=_scaled(want["avg"][..., :3], AVG_RTOL))
    np.testing.assert_allclose(frame.numpy(), want["frame"].numpy(), rtol=0,
                               atol=_scaled(want["frame"], frame_rtol))


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_path_matches_reference(seed):
    """The grid-parity path, ``step`` and ``density``, three frames."""
    sim = _port(seed)
    gen = torch.Generator().manual_seed(seed)
    st = sim.state
    pos, vel, alive, avg = (st.position, st.velocity, st.alive,
                            st.moments_avg)
    respawned = 0
    for _ in range(FRAMES):
        rands = torch.stack([substep_uniforms(gen, SPEC["nparticles"] ** 2,
                                              "cpu") for _ in range(2)])
        want = ref.frame(PHYS, pos, vel, alive, avg, rands)
        sim.state = sim._step(sim.fields, sim.state, list(rands))
        frame = sim.density()
        st = sim.state
        _compare_rows((st.position, st.velocity, st.alive), want)
        _compare_grids(st.moments_avg, frame, want)
        respawned += int((~want["survived"]).sum())
        pos, vel, alive, avg = (st.position, st.velocity, st.alive,
                                st.moments_avg)
    assert respawned > 10, "needs respawns"


@pytest.mark.parametrize("seed", [1, 2])
def test_sorted_fused_path_matches_reference(seed):
    """The tile-sorted path on backend 'fused' (B2's plain version on the
    CPU), three frames without a resort: the layout's real rows against
    the reference's, each given the uniforms of its slot."""
    sim = _port(seed)
    spec = sim.spec
    tiling = stream_tiling_for(spec.nr, spec.nz, margin=2)
    state = tps.to_sorted_state(sim.state, spec, tiling)
    step = tps.make_sorted_step_fn(spec, tiling, 4096, "fused")
    density = tps.make_sorted_density_fn(spec)
    gen = torch.Generator().manual_seed(seed)
    spilled = 0
    for _ in range(FRAMES):
        v = state.valid
        rands = torch.stack([substep_uniforms(gen, v.shape[0], "cpu")
                             for _ in range(2)])
        want = ref.frame(PHYS, state.position[v], state.velocity[v],
                         state.alive[v], state.moments_avg, rands[:, v])
        spill = state.spill
        state = step(sim.fields, state, list(rands))
        state, frame = density(sim.fields, state)
        spilled += state.spill - spill
        assert torch.equal(state.valid, v)
        _compare_rows((state.position[v], state.velocity[v],
                       state.alive[v]), want)
        _compare_grids(state.moments_avg, frame, want)
    assert spilled > 0, "needs rows through the exact patch"
    assert state.dropped == state.dropped_over == 0


def test_reference_matches_jax_package():
    """The JAX package's pusher (``fusion_sim_tpu``) a frame at a time,
    the reference handed JAX's own uniforms for it."""
    from fusion_sim_tpu.models import pusher as jpm
    from fusion_sim_tpu.ops.rng import substep_uniforms as j_uniforms
    from fusion_sim_tpu.scenarios import apply_default_scenario as j_apply

    jsim = jpm.CylindricalParticlePusher(SPEC, seed=3)
    j_apply(jsim, seed=3)
    jsim.set(dict(zip(("position", "velocity"), _load(3))))
    respawned = 0
    for _ in range(FRAMES):
        st = jsim.state
        r1, key = j_uniforms(st.key, SPEC["nparticles"] ** 2)
        r2, _ = j_uniforms(key, SPEC["nparticles"] ** 2)
        rands = torch.tensor(np.stack([np.asarray(r1), np.asarray(r2)]))
        want = ref.frame(PHYS, *(torch.tensor(np.asarray(t)) for t in (
            st.position, st.velocity, st.alive, st.moments_avg)), rands)
        jsim.step(1)
        frame = torch.tensor(np.asarray(jsim.density()))
        st = jsim.state
        _compare_rows(tuple(torch.tensor(np.asarray(t)) for t in (
            st.position, st.velocity, st.alive)), want, JAX_RTOL)
        _compare_grids(torch.tensor(np.asarray(st.moments_avg)), frame,
                       want, JAX_RTOL)
        respawned += int((~want["survived"]).sum())
    assert respawned > 10, "needs respawns"
