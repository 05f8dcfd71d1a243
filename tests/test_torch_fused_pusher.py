"""Port vs reference: the fused pusher half-step (kernel B2).

On the CPU ``fused_pusher_substep`` runs its plain PyTorch version; the JAX
kernel runs in Pallas interpret mode.  Both get the same inputs: the
default scenario's coefficient table and a sorted layout built by the
reference, edited so that it holds fresh rows (alive 0), rows at the
clamp edge of the grid, a last-r-tile row whose two samples disagree on
the window, and (second case) heavy spill.  in_win and sink must be equal
on every valid row, positions and velocities within 1e-6 relative.  The
CUDA kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.ops import fused_pusher as tfp
from fusion_sim_torch.ops.sorted_deposit import Tiling2D as TTiling
from fusion_sim_tpu.models.pusher import CylindricalParticlePusher
from fusion_sim_tpu.models.pusher_sorted import Tiling2D as JTiling
from fusion_sim_tpu.models.pusher_sorted import _cell_coords
from fusion_sim_tpu.ops.pallas_pusher import fused_pusher_substep
from fusion_sim_tpu.ops.pallas_pusher import stream_tiling_for
from fusion_sim_tpu.scenarios import apply_default_scenario

NR, NZ = 32, 64
TILE = dict(tile_r=8, tile_z=16, block=128, margin=2)
SPEC = {"radius": 1.0, "height": 2.0, "nr": NR, "nz": NZ, "dt": 2e-9,
        "nparticles": 32, "particle_mass": 1.67e-27,
        "particle_charge": 1.602e-19}
STEP_FACTOR = 2e-9 * 2.998e8


@pytest.fixture(scope="module")
def case():
    sim = CylindricalParticlePusher(SPEC, seed=3)
    apply_default_scenario(sim, seed=3)
    sim.enable_sorted_path(tiling=JTiling(**TILE), resort_every=4)
    st, f = sim._sorted_state, sim.fields
    packed13 = np.asarray(jnp.concatenate(
        [f.coeffs.r1, f.coeffs.r2, f.coeffs.r3, f.coeffs.a,
         f.sink_mask[..., None]], axis=-1))
    pos = np.asarray(st.position).copy()
    vel = np.asarray(st.velocity).copy()
    alive = np.asarray(st.alive).copy()
    valid = np.asarray(st.valid)
    tid = np.asarray(st.tile_id).copy()
    rng = np.random.default_rng(0)
    rand = rng.random((len(pos), 4)).astype(np.float32)
    rows = np.flatnonzero(valid)
    alive[rows[-20:]] = 0.0                     # fresh: thermal re-init
    # the particles start near the axis: relabel two full blocks, one to
    # the last r-tile and one to the last z-tile of their own tile column
    # or row (every row of a block lies in one tile, so a block may carry
    # any tile id), and place rows at the clamp edges in them
    ntr, ntz = NR // TILE["tile_r"], NZ // TILE["tile_z"]
    blk = TILE["block"]
    full = [b for b in range(len(pos) // blk)
            if valid[b * blk:(b + 1) * blk].all()]
    assert len(full) >= 2, "needs two full blocks"
    b_r, b_z = (slice(b * blk, (b + 1) * blk) for b in full[:2])
    tid[b_r] = (ntr - 1) * ntz + tid[b_r.start] % ntz
    tid[b_z] = (tid[b_z.start] // ntz) * ntz + ntz - 1
    r_rows = np.arange(b_r.start, b_r.stop)
    z_rows = np.arange(b_z.start, b_z.stop)
    pos[r_rows[:4], :2] = (1.2, 0.0)            # r*nr clamps to nr - 1e-3
    pos[z_rows[:4], 2] = 1.0                    # z*nz clamps to nz - 1e-3
    # r*nr = 0.5 in a last-r-tile block: the coefficient sample wraps
    # into the window, the sink sample (no wrap) does not
    pos[r_rows[4:8], :2] = (0.5 / NR, 0.0)
    return dict(packed13=packed13, pos=pos, vel=vel, alive=alive, rand=rand,
                tid=tid, valid=valid,
                edge=np.r_[r_rows[:4], z_rows[:4]], wrapped=r_rows[4:8])


def _run_both(c, vel):
    ref = fused_pusher_substep(
        jnp.asarray(c["packed13"]), jnp.asarray(c["pos"]), jnp.asarray(vel),
        jnp.asarray(c["alive"]), jnp.asarray(c["rand"]),
        _cell_coords(jnp.asarray(c["pos"]), NR, NZ), jnp.asarray(c["tid"]),
        NR, NZ, JTiling(**TILE), STEP_FACTOR, interpret=True)
    got = tfp.fused_pusher_substep(
        *map(torch.tensor, (c["packed13"], c["pos"], vel, c["alive"],
                            c["rand"], c["tid"])),
        NR, NZ, TTiling(**TILE), STEP_FACTOR)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _check(ref, got, valid):
    np.testing.assert_array_equal(got[3][valid], ref[3][valid])   # in_win
    np.testing.assert_array_equal(got[2][valid], ref[2][valid])   # sink
    for i in (0, 1):
        scale = np.abs(ref[i][valid]).max()
        np.testing.assert_allclose(got[i][valid], ref[i][valid], rtol=1e-6,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("vscale", [1.0, 40.0])   # scenario / heavy spill
def test_fused_pusher_substep_matches_reference(case, vscale):
    valid = case["valid"]
    ref, got = _run_both(case, (case["vel"] * vscale).astype(np.float32))
    _check(ref, got, valid)
    spilled = valid & ~got[3]
    assert not got[3][case["wrapped"]].any()
    # frozen rows: inputs back, sink 1
    np.testing.assert_array_equal(got[0][spilled], case["pos"][spilled])
    assert (got[2][spilled] == 1.0).all()
    fresh = valid & (case["alive"] <= 0.5) & got[3]
    assert fresh.sum() >= 10
    np.testing.assert_array_equal(
        got[1][fresh], 0.001 * (2.0 * case["rand"][fresh, :3] - 1.0))
    if vscale > 1:
        assert spilled.sum() > 100, "needs heavy spill"
    else:
        assert got[3][case["edge"]].all(), "edge rows stay in their window"


def test_stream_tiling_for_matches_reference():
    for nr, nz, m in ((400, 800, 6), (64, 128, 3), (32, 64, 2)):
        want = stream_tiling_for(nr, nz, margin=m)
        got = tfp.stream_tiling_for(nr, nz, margin=m)
        assert (got.tile_r, got.tile_z, got.block, got.margin) == (
            want.tile_r, want.tile_z, want.block, want.margin)
    assert tfp.stream_tiling_for(400, 800, 6) == TTiling(8, 100, 1024, 6)


def test_cell_coords_matches_reference(case):
    got = tfp.cell_coords(torch.tensor(case["pos"]), NR, NZ).numpy()
    ref = np.asarray(_cell_coords(jnp.asarray(case["pos"]), NR, NZ))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got[:, 0].max() == np.float32(NR - 1e-3)
