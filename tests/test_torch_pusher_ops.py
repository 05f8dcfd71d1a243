"""Port vs reference: the pusher's ops (constants, config, rng, boris,
fields, sampling, push, deposit, render), one function at a time.

The same numpy inputs (from a seed) go through the JAX function and its
port, both on the CPU.  Index-based results (nearest gathers, table
lookups, sink, respawn, cell indices) must be equal; arithmetic agrees to
1e-6 of the output's scale, except where a comment states why not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch import config as tconfig
from fusion_sim_torch import constants as tconst
from fusion_sim_torch.models.pusher import SPEC_SCHEMA as T_SCHEMA
from fusion_sim_torch.ops import boris as tb
from fusion_sim_torch.ops import deposit as td
from fusion_sim_torch.ops import fields as tf
from fusion_sim_torch.ops import push as tp
from fusion_sim_torch.ops import rng as trng
from fusion_sim_torch.ops import sampling as ts
from fusion_sim_torch.utils import render as tr
from fusion_sim_tpu import config as jconfig
from fusion_sim_tpu import constants as jconst
from fusion_sim_tpu.models.pusher import SPEC_SCHEMA as J_SCHEMA
from fusion_sim_tpu.ops import boris as jb
from fusion_sim_tpu.ops import deposit as jd
from fusion_sim_tpu.ops import fields as jf
from fusion_sim_tpu.ops import push as jp
from fusion_sim_tpu.ops import rng as jrng
from fusion_sim_tpu.ops import sampling as js
from fusion_sim_tpu.utils import render as jr

NR, NZ = 24, 40
H = 1.602e-19 * 2e-9 / (2 * 1.67e-27)
STEP_FACTOR = 2e-9 * 2.998e8


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, ref, rel=1e-6):
    """|got - ref| <= rel * max|ref| elementwise."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def equal(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((NR, NZ, 3)).astype(np.float32)
    e = (1e6 * rng.standard_normal((NR, NZ, 3))).astype(np.float32)
    return b, e


def _particles(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.array([1.4, 1.4, 1.0])
           - np.array([0.7, 0.7, 0.0])).astype(np.float32)
    vel = (1e-3 * rng.standard_normal((n, 3))).astype(np.float32)
    alive = (rng.random(n) > 0.2).astype(np.float32)
    rand = rng.random((n, 4)).astype(np.float32)
    return pos, vel, alive, rand


def _sink_and_source():
    sink = np.ones((NR, NZ), np.float32)
    sink[-1] = 0
    sink[1:-1, 0] = 0
    sink[1:-1, -1] = 0
    src = np.zeros((NR, NZ), np.float32)
    src[:NR // 8, 7 * NZ // 16:9 * NZ // 16] = 1.0
    return sink, src


# -- constants, config, rng ---------------------------------------------------

def test_constants_match():
    for name in ("SPEED_OF_LIGHT", "MU_0", "PI"):
        assert getattr(tconst, name) == getattr(jconst, name)


@pytest.mark.parametrize("spec", [
    {"radius": 1.0, "height": 2.0, "nr": 8, "nz": 8, "dt": 1e-9,
     "nparticles": 4, "particle_mass": 1.0, "particle_charge": 1.0},
    {"radius": 1.0, "height": 2.0, "nr": 8, "nz": 8, "dt": 1e-9,
     "nparticles": 4, "particle_mass": 1.0, "particle_charge": 1.0,
     "interp": "bilinear"},
    {"radius": 1.0, "nr": 8},                                 # missing
    {"radius": True, "height": 2.0, "nr": 8, "nz": 8, "dt": 1e-9,
     "nparticles": 4, "particle_mass": 1.0, "particle_charge": 1.0},
    {"radius": 1.0, "height": 2.0, "nr": 8, "nz": 8, "dt": 1e-9,
     "nparticles": 4, "particle_mass": 1.0, "particle_charge": 1.0,
     "interp": 3},
])
def test_spec_validation_matches(spec):
    def outcome(module, schema):
        try:
            module.validate_object(spec, schema)
        except module.SpecError as exc:
            return str(exc)
        return None

    assert outcome(tconfig, T_SCHEMA) == outcome(jconfig, J_SCHEMA)


def test_config_unions_and_nested_objects():
    schema = {"a": ["number", "string"], "o": {"x": "number"},
              "f": tconfig.Optional("function"),
              "p": lambda v: v > 0}
    tconfig.validate_object({"a": "s", "o": {"x": 1}, "p": 2}, schema)
    with pytest.raises(tconfig.SpecError, match="o.x"):
        tconfig.validate_object({"a": 1, "o": {"x": "no"}, "p": 2}, schema)
    with pytest.raises(tconfig.SpecError, match="union"):
        tconfig.validate_object({"a": [], "o": {"x": 1}, "p": 2}, schema)
    with pytest.raises(tconfig.SpecError, match="predicate"):
        tconfig.validate_object({"a": 1, "o": {"x": 1}, "p": -1}, schema)


def test_substep_uniforms_match_in_distribution():
    """Torch's Philox cannot replay threefry: same shape, dtype and range,
    and the same distribution (two-sample KS distance, 1e5 draws a
    column: below 0.01 fails with probability ~1e-4 under equality)."""
    gen = torch.Generator().manual_seed(0)
    got = trng.substep_uniforms(gen, 100_000, "cpu")
    ref = np.asarray(jrng.substep_uniforms(jax.random.key(0), 100_000)[0])
    assert got.shape == ref.shape and got.dtype == torch.float32
    g = got.numpy()
    assert g.min() >= 0.0 and g.max() < 1.0
    grid = np.linspace(0, 1, 201)
    for c in range(4):
        cdf_g = np.searchsorted(np.sort(g[:, c]), grid) / len(g)
        cdf_r = np.searchsorted(np.sort(ref[:, c]), grid) / len(ref)
        assert np.abs(cdf_g - cdf_r).max() < 0.01
    # a generator replays its own stream
    again = trng.substep_uniforms(torch.Generator().manual_seed(0), 100_000,
                                  "cpu")
    assert torch.equal(got, again)


# -- boris ------------------------------------------------------------------------

def _coeffs():
    b, e = _fields()
    return (jb.precompute_rotation(b, e, H, 1.0, 0.5),
            tb.precompute_rotation(T(b), T(e), H, 1.0, 0.5))


def test_precompute_rotation_matches():
    cj, ct = _coeffs()
    for k in ("r1", "r2", "r3", "a"):
        close(getattr(ct, k), getattr(cj, k))


def test_gather_nearest_and_bilinear_match():
    cj, _ = _coeffs()
    packed = np.concatenate([np.asarray(getattr(cj, k))
                             for k in ("r1", "r2", "r3", "a")], -1)
    pos = _particles()[0]
    r = np.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2).astype(np.float32)
    equal(tb.gather_nearest(T(packed), T(r), T(pos[:, 2])),
          jb.gather_nearest(packed, r, pos[:, 2]))
    close(tb.gather_bilinear(T(packed), T(r), T(pos[:, 2])),
          jb.gather_bilinear(packed, r, pos[:, 2]))


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_push_velocity_matches(interp):
    cj, _ = _coeffs()
    ct = tb.BorisCoefficients(*(T(getattr(cj, k)) for k in
                                ("r1", "r2", "r3", "a")))
    pos, vel, alive, rand = _particles()
    got = tb.push_velocity(T(pos), T(vel), T(alive), T(rand), ct,
                           interp=interp)
    ref = jb.push_velocity(pos, vel, alive, rand, cj, interp=interp)
    close(got, ref)
    fresh = alive <= 0.5
    equal(got.numpy()[fresh], np.asarray(ref)[fresh])    # thermal re-init
    with pytest.raises(ValueError, match="interp"):
        tb.push_velocity(T(pos), T(vel), T(alive), T(rand), ct, "cubic")


# -- fields ---------------------------------------------------------------------

def test_grid_coords_and_nearest_lookup_match():
    for a, b in zip(tf.grid_coords(NR, NZ), jf.grid_coords(NR, NZ)):
        equal(a, b)
    table = np.random.default_rng(3).standard_normal((50, 30, 3)).astype(
        np.float32)
    u = np.linspace(-0.2, 1.2, 97).astype(np.float32)
    v = np.linspace(1.3, -0.1, 97).astype(np.float32)
    equal(tf.nearest_lookup_2d(T(table), T(u), T(v)),
          jf.nearest_lookup_2d(table, u, v))


@pytest.mark.parametrize("radius", [0.5, 0.1])
def test_current_loop_shape_table_matches(radius):
    """The 1000-term f32 quadrature, summed in the same order.  XLA
    contracts the loop body into FMAs and evaluates cos with its own
    approximation, so the two f32 sums drift apart by up to ~6e-5 of the
    table's scale — about as far as each is from a float64 sum of the
    same quadrature (ROADMAP Queue C).  Both are held to 2e-4 of the scale
    against float64, and to each other."""
    got = tf.current_loop_shape_table(NR, NZ, radius).numpy()
    ref = np.asarray(jf.current_loop_shape_table(NR, NZ, radius))
    x = ((np.arange(NR) + 0.5) / NR)[:, None]
    y = ((np.arange(NZ) + 0.5) / NZ)[None, :]
    const = radius * 0.001 * jconst.MU_0 / (4 * jconst.PI)
    bx = np.zeros((NR, NZ))
    bz = np.zeros((NR, NZ))
    for k in range(1000):
        c = np.cos(jconst.PI * (k + 0.5) / 1000)
        f = const / np.sqrt(radius ** 2 + x * x + y * y
                            - 2 * x * radius * c) ** 3
        bx += y * f * c
        bz += f * (radius - x * c)
    exact = np.stack([bx, 0 * bx, bz], -1)
    for table in (got, ref):
        close(table, exact, rel=2e-4)
    close(got, ref, rel=2e-4)
    assert (got[..., 1] == 0).all()


def test_current_loop_b_table_matches_on_the_same_tables():
    """Given the reference's own shape tables, every NEAREST index and so
    every value is the same, for the default scenario's two coils.  (XLA's
    f32 division on the CPU is not always correctly rounded — x / 0.05
    differs from IEEE in the last place at 8 of 24 texel centres — so at
    other loop radii a lookup at a cell edge can flip; ROADMAP Queue C.)"""
    half, tenth = jf.make_loop_tables(NR, NZ)
    for r, z, cur in ((0.8, 2.0, -1e7), (0.8, 0.0, 1e7)):
        equal(tf.current_loop_b_table(T(half), T(tenth), r, z, cur),
              jf.current_loop_b_table(half, tenth, jnp.float32(r),
                                      jnp.float32(z), jnp.float32(cur)))


def test_current_loop_b_exact_and_ellipke_match():
    u, v = jf.grid_coords(NR, NZ)
    rp = np.broadcast_to(np.asarray(u) * 1.0, (NR, NZ)).copy()
    zp = np.broadcast_to(np.asarray(v) * 2.0, (NR, NZ)).copy()
    rp[0, :3] = 0.0                                   # on-axis branch
    close(tf.current_loop_b_exact(T(rp), T(zp), 0.8, 2.0, 1e7),
          jf.current_loop_b_exact(jnp.asarray(rp), jnp.asarray(zp),
                                  jnp.float32(0.8), jnp.float32(2.0),
                                  jnp.float32(1e7)))
    m = (np.random.default_rng(4).random(1000) * 0.999).astype(np.float32)
    for got, ref in zip(tf._ellipke(T(m)), jf._ellipke(jnp.asarray(m))):
        close(got, ref)


def test_line_and_uniform_fields_match():
    equal(tf.line_current_b(NR, NZ, 3e5),
          jf.line_current_b(NR, NZ, jnp.float32(3e5)))
    equal(tf.uniform_bz(NR, NZ, 0.3), jf.uniform_bz(NR, NZ, 0.3))
    equal(tf.uniform_btheta(NR, NZ, -0.7), jf.uniform_btheta(NR, NZ, -0.7))


# -- sampling -------------------------------------------------------------------

def test_inverse_cdf_table_matches():
    _, src = _sink_and_source()
    # the default scenario's box source: integer-valued CDF sums, exact
    equal(ts.build_inverse_cdf_table(T(src)), js.build_inverse_cdf_table(src))
    # a general PDF with empty rows: the f32 cumulative sums run in another
    # order (XLA's windowed scan vs torch's), ~5e-6 of the unit range
    pdf = np.random.default_rng(5).random((NR, NZ)).astype(np.float32)
    pdf[3] = 0
    pdf[-1] = 0
    close(ts.build_inverse_cdf_table(T(pdf)), js.build_inverse_cdf_table(pdf),
          rel=2e-5)
    cdf = np.cumsum(np.r_[0, 0, 1, 2, 0, 3]).astype(np.float32) / 6
    f = np.linspace(0, 1, 33).astype(np.float32)
    close(ts._inverse_interp(T(cdf), T(f)),
          js._inverse_interp(jnp.asarray(cdf), jnp.asarray(f)))


def test_sample_inverse_cdf_matches():
    _, src = _sink_and_source()
    table = np.asarray(js.build_inverse_cdf_table(src))
    rand = _particles()[3]
    for got, ref in zip(ts.sample_inverse_cdf(T(table), T(rand[:, 0]),
                                              T(rand[:, 1])),
                        js.sample_inverse_cdf(table, rand[:, 0], rand[:, 1])):
        equal(got, ref)


# -- push -----------------------------------------------------------------------

def test_push_position_matches():
    sink, src = _sink_and_source()
    table = np.asarray(js.build_inverse_cdf_table(src))
    pos, vel, _, rand = _particles()
    pos[:, 2] = np.abs(pos[:, 2])
    vel = vel * 300           # drifts across the walls: respawns
    got = tp.push_position(T(pos), T(vel), T(rand), T(sink), T(table),
                           STEP_FACTOR)
    ref = jp.push_position(pos, vel, rand, sink, table, STEP_FACTOR)
    assert (np.asarray(ref[1]) == 0).sum() > 50, "needs respawns"
    for g, r in zip(got, ref):
        equal(g, r)


@pytest.mark.parametrize("capacity", [None, 1000, 50])
def test_sink_respawn_matches(capacity):
    """With a capacity the first ``capacity`` respawning rows (row order)
    respawn; the rest keep their drifted position with alive = 0."""
    _, src = _sink_and_source()
    table = np.asarray(js.build_inverse_cdf_table(src))
    pos, _, _, rand = _particles()
    sink = (np.random.default_rng(6).random(len(pos)) > 0.1).astype(
        np.float32)
    got = tp.sink_respawn(T(pos), T(sink), T(rand), T(table),
                          respawn_capacity=capacity)
    ref = jp.sink_respawn(jnp.asarray(pos), jnp.asarray(sink),
                          jnp.asarray(rand), jnp.asarray(table),
                          respawn_capacity=capacity)
    equal(got[0], ref[0])
    equal(got[1], ref[1])
    assert got[2] == int(ref[2]) == (0 if capacity != 50 else
                                     int((sink <= 0.5).sum()) - 50)


# -- deposit, render --------------------------------------------------------------

def test_bell_and_cell_indices_match():
    equal(td.bell_kernel(), jd.bell_kernel())
    pos = _particles()[0]
    got = td.particle_cell_indices(T(pos), NR, NZ)
    ref = jd.particle_cell_indices(pos, NR, NZ)
    equal(got[0], ref[0])
    equal(got[1], ref[1])
    close(got[2], ref[2])   # XLA contracts x*x + y*y into an FMA


def test_deposit_normalize_ema_match():
    pos, vel, _, _ = _particles()
    pos[:, 2] = np.abs(pos[:, 2])
    w = (np.random.default_rng(7).random(len(pos)) > 0.3).astype(np.float32)
    ref = jd.deposit_moments(pos, vel, NR, NZ, weights=jnp.asarray(w))
    close(td.deposit_moments(T(pos), T(vel), NR, NZ, weights=T(w)), ref)
    close(td.deposit_moments(T(pos), T(vel), NR, NZ),
          jd.deposit_moments(pos, vel, NR, NZ))
    norm = jd.normalize_moments(ref)
    close(td.normalize_moments(T(ref)), norm)
    close(td.ema_moments(T(norm), T(norm) * 0.5),
          jd.ema_moments(norm, norm * 0.5))


def test_render_matches():
    b, _ = _fields()
    b[0, 0] = 0.0                                        # |B| = 0 branch
    close(tr.render_bmag(T(b)), jr.render_bmag(b))
    bg = np.asarray(jr.render_bmag(b))
    avg = np.random.default_rng(8).random((NR, NZ, 4)).astype(np.float32)
    equal(tr.render_density_overlay(T(bg), T(avg)),
          jr.render_density_overlay(bg, avg))
