"""Port vs reference: the spindle-cusp boundary-element solve
(fusion_sim_torch/models/spindle.py) and the pusher's
``add_spindle_cusp_plasma_field``, modelled on tests/test_spindle.py.

The BEM matrix's condition number is 20 at n_power 1 and 92 at n_power 2,
so the currents are compared from the reference's own matrix and b, where
it does not amplify f32 differences of the element fields, and from each
package's own matrix at a looser bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.models import pusher as tpm
from fusion_sim_torch.models import spindle as ts
from fusion_sim_torch.ops import solvers as tsol
from fusion_sim_tpu.models import pusher as jpm
from fusion_sim_tpu.models import spindle as js
from fusion_sim_tpu.ops import solvers as jsol

RADIUS, HEIGHT, CURRENT = 1.0, 2.0, 1e6


def _n_loops(n_power):
    return 4 * (2 ** n_power) ** 2


@pytest.mark.parametrize("n_loops", [16, 64, 256])
def test_geometry_matches_reference(n_loops):
    """numpy float64 cast to f32 in both packages: equal to 1e-6 (in fact
    bit for bit)."""
    gj = js.build_geometry(RADIUS, HEIGHT, n_loops)
    gt = ts.build_geometry(RADIUS, HEIGHT, n_loops, device="cpu")
    for name in ("points", "normals", "loops"):
        got = getattr(gt, name)
        assert got.dtype == torch.float32 and got.shape == (n_loops, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(gj, name)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_power", [1, 2])
def test_bem_matrix_matches_reference(n_power):
    n = _n_loops(n_power)
    gj = js.build_geometry(RADIUS, HEIGHT, n)
    gt = ts.build_geometry(RADIUS, HEIGHT, n, device="cpu")
    a_t = ts._bem_matrix(gt, HEIGHT).numpy()
    # the reference's vmapped function run op by op: the same f32 closed
    # form in the same order, 1e-5 of max|A| (measured ~2e-8)
    with jax.disable_jit():
        a_eager = np.asarray(js._bem_matrix(gj, HEIGHT))
    scale = np.abs(a_eager).max()
    np.testing.assert_allclose(a_t, a_eager, rtol=0, atol=1e-5 * scale)
    # the reference as shipped, under jit: XLA's fused arithmetic moves the
    # self-element entries (point and loop ~1e-4 m apart, where the
    # elliptic integrals' log(1 - m) amplifies an ulp of m) by up to 9e-4
    # of max|A| at n_power 2; every other entry stays within 1e-5
    a_jit = np.asarray(js._bem_matrix(gj, HEIGHT))
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_allclose(a_t[off], a_jit[off], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.diag(a_t), np.diag(a_jit), rtol=0,
                               atol=2e-3 * scale)


@pytest.mark.parametrize("n_power", [1, 2])
def test_currents_from_reference_matrix_match(n_power):
    """The reference's A and b through both packages' SOR wrappers
    (set_matrix / set_b / init_vector), and the direct solve of the same
    system: currents within 1e-5 of max|x|."""
    n = _n_loops(n_power)
    gj = js.build_geometry(RADIUS, HEIGHT, n)
    a = np.asarray(js._bem_matrix(gj, HEIGHT))
    inc = js.coil_field(gj.points[:, 0], gj.points[:, 1], RADIUS, HEIGHT,
                        CURRENT)
    b = np.asarray(-(gj.normals[:, 0] * inc[:, 0]
                     + gj.normals[:, 1] * inc[:, 2]))
    x0 = np.zeros(n, np.float32)
    params = {"tolerance": 1e-3, "max_iterations": 10}
    ref = jsol.SORIterative(n_power).set_matrix(a).set_b(b).init_vector(x0)
    out = tsol.SORIterative(n_power, device="cpu").set_matrix(a).set_b(
        b).init_vector(x0)
    r_ref, r_out = ref.solve(params), out.solve(params)
    assert r_out["iterations"] == r_ref["iterations"]
    x_ref = np.asarray(r_ref["result"])
    np.testing.assert_allclose(r_out["result"].numpy(), x_ref, rtol=0,
                               atol=1e-5 * np.abs(x_ref).max())
    np.testing.assert_allclose(r_out["diff"], r_ref["diff"], rtol=1e-5)
    np.testing.assert_allclose(r_out["correlation"], r_ref["correlation"],
                               atol=1e-6)

    # the port's b from its own coil field equals the reference's b
    gt = ts.build_geometry(RADIUS, HEIGHT, n, device="cpu")
    inc_t = ts.coil_field(gt.points[:, 0], gt.points[:, 1], RADIUS, HEIGHT,
                          CURRENT)
    b_t = -ts._normal_component(gt.normals, inc_t).numpy()
    np.testing.assert_allclose(b_t, b, rtol=0, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("n_power", [1, 2, 3])
def test_currents_from_own_matrix(n_power):
    """Each package solves its own system.  The matrices differ by the
    reference's jit rounding of the self-element entries (above), which the
    condition number (20-385) carries into the currents: measured 1e-6,
    5e-6 and 1.5e-5 of max|x| (direct) and 1.4e-4 at n_power 3 (10 Jacobi
    iterations); held at 1e-4 and 1e-3."""
    n = _n_loops(n_power)
    for method, tol in (("direct", 1e-4), ("jacobi", 1e-3)):
        _, x_ref, info_ref = js.solve_surface_currents(
            RADIUS, HEIGHT, CURRENT, n_loops=n, method=method)
        geom, x, info = ts.solve_surface_currents(
            RADIUS, HEIGHT, CURRENT, n_loops=n, method=method, device="cpu")
        x_ref = np.asarray(x_ref)
        assert x.dtype == torch.float32 and x.shape == (n,)
        np.testing.assert_allclose(x.numpy(), x_ref, rtol=0,
                                   atol=tol * np.abs(x_ref).max())
        assert info.keys() == info_ref.keys()
        assert info["method"] == method
        if method == "jacobi":
            # the reference's call never converged (spindle.py:24-29)
            assert info["iterations"] == info_ref["iterations"] == 10


def test_jacobi_method_matches_reference():
    """The reference's solver call (tol 1e-3, <= 10 Jacobi iterations,
    spindle.js:632-636) at 16 loops: 10 iterations, not converged; diff
    within 1e-4 of itself and correlation within 1e-6 (the matrices differ
    by ~2.5e-6 of max|A|)."""
    _, x_ref, ref = js.solve_surface_currents(RADIUS, HEIGHT, CURRENT,
                                              n_loops=16, method="jacobi")
    _, x, out = ts.solve_surface_currents(RADIUS, HEIGHT, CURRENT,
                                          n_loops=16, method="jacobi",
                                          device="cpu")
    assert out["iterations"] == ref["iterations"] == 10
    assert isinstance(out["diff"], float) and out["diff"] > 1e-3
    np.testing.assert_allclose(out["diff"], ref["diff"], rtol=1e-4)
    np.testing.assert_allclose(out["correlation"], ref["correlation"],
                               atol=1e-6)
    assert bool(torch.isfinite(x).all())
    with pytest.raises(ValueError, match="unknown method"):
        ts.solve_surface_currents(RADIUS, HEIGHT, CURRENT, n_loops=16,
                                  method="cg", device="cpu")


def test_spindle_cusp_field_matches_reference_scan():
    """24 x 48 at n_power 1 against the reference's lax.scan: 1e-5 of
    max|B| (measured 1.1e-6); with the coils added as well."""
    for coils in (False, True):
        ref = np.asarray(js.spindle_cusp_field(RADIUS, HEIGHT, 24, 48,
                                               CURRENT, n_power=1,
                                               include_coils=coils))
        got = ts.spindle_cusp_field(RADIUS, HEIGHT, 24, 48, CURRENT,
                                    n_power=1, include_coils=coils,
                                    device="cpu").numpy()
        assert got.shape == (24, 48, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_grid_field_chunks_sum_in_loop_order(monkeypatch):
    """Chunks of 3 loops give the bits of one loop at a time: the f32 sum
    runs in loop order whatever the chunk."""
    geom, x, _ = ts.solve_surface_currents(RADIUS, HEIGHT, CURRENT,
                                           n_loops=16, device="cpu")
    whole = ts.grid_field(geom, x, RADIUS, HEIGHT, 12, 20)
    monkeypatch.setattr(ts, "_CHUNK_POINTS", 3 * 12 * 20)
    chunked = ts.grid_field(geom, x, RADIUS, HEIGHT, 12, 20)
    monkeypatch.setattr(ts, "_CHUNK_POINTS", 1)
    single = ts.grid_field(geom, x, RADIUS, HEIGHT, 12, 20)
    assert torch.equal(whole, chunked) and torch.equal(whole, single)


def test_normal_field_cancellation():
    """tests/test_spindle.py's statement on the port: after the solve, B_n
    of coils + surface currents at the collocation points is < 1e-3 of the
    incident field."""
    geom, currents, _ = ts.solve_surface_currents(
        RADIUS, HEIGHT, CURRENT, n_loops=64, method="direct", device="cpu")
    inc = ts.coil_field(geom.points[:, 0], geom.points[:, 1], RADIUS,
                        HEIGHT, CURRENT)
    bn_inc = ts._normal_component(geom.normals, inc).numpy()
    total = bn_inc.astype(np.float64).copy()
    for i in range(64):
        f = ts.element_field(geom.points[:, 0], geom.points[:, 1],
                             geom.loops[i], HEIGHT)
        total += float(currents[i]) * ts._normal_component(
            geom.normals, f).numpy()
    scale = np.abs(bn_inc).max()
    assert np.abs(total).max() < 1e-3 * scale, (np.abs(total).max(), scale)


def test_grid_field_midplane_antisymmetry():
    b = ts.spindle_cusp_field(RADIUS, HEIGHT, 24, 48, CURRENT, n_power=1,
                              device="cpu").numpy()
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b[:, :24, 2], -b[:, :23:-1, 2],
                               atol=1e-3 * np.abs(b[..., 2]).max())
    np.testing.assert_allclose(b[:, :24, 0], b[:, :23:-1, 0],
                               atol=1e-3 * np.abs(b[..., 0]).max())


def test_pusher_add_spindle_matches_reference():
    """add_spindle_cusp_plasma_field on a 16 x 32 pusher: B equal to the
    reference pusher's within 1e-5 of max|B|, the source recorded, the
    fast path refused."""
    spec = {"radius": 1.0, "height": 2.0, "nr": 16, "nz": 32, "dt": 2e-9,
            "nparticles": 8, "particle_mass": 1.67e-27,
            "particle_charge": 1.602e-19}
    ref = jpm.CylindricalParticlePusher(spec)
    port = tpm.CylindricalParticlePusher(spec, device="cpu")
    for sim in (ref, port):
        sim.add_bz(0.01)
        sim.add_spindle_cusp_plasma_field(CURRENT, n_power=1)
    b_ref = np.asarray(ref.fields.b)
    b = port.fields.b.numpy()
    np.testing.assert_allclose(b, b_ref, rtol=0,
                               atol=1e-5 * np.abs(b_ref).max())
    assert port._sources == ref._sources == [("bz", 0.01), ("spindle",)]
    with pytest.raises(ValueError, match="analytic sources"):
        port.enable_fast_path()
    rng = np.random.default_rng(0)
    pos = np.stack([0.2 + 0.3 * rng.random(64), np.zeros(64),
                    0.8 + 0.4 * rng.random(64)], axis=1)
    port.set({"position": pos, "velocity": 1e-3 * rng.standard_normal(
        (64, 3))})
    port.precalc()
    port.step(2)
    assert bool(torch.isfinite(port.state.velocity).all())
    assert bool(jnp.isfinite(ref.fields.b).all())
