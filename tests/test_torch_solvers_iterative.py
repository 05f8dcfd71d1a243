"""Port vs reference: the iterative solvers (weighted Jacobi, the SOR
wrapper, conjugate gradient) and the block reductions
(fusion_sim_torch/ops/solvers.py, ops/reduce.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.config import SpecError
from fusion_sim_torch.ops import reduce as tr
from fusion_sim_torch.ops import solvers as tp
from fusion_sim_tpu.ops import reduce as jr
from fusion_sim_tpu.ops import solvers as jx


def _dominant(n, scale, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)).astype(np.float32) * scale
    a += np.diag(np.abs(a).sum(axis=1) + 1.0).astype(np.float32)
    return a, rng.random(n).astype(np.float32)


# (n, off-diagonal scale, seed, kwargs): tests/test_solvers.py's systems,
# substeps between checks, under-relaxation and a capped iteration count.
# The tolerances sit 30-45 ulp-steps of diff above its f32 floor (see
# below), where sums in another order do not move the stop
JACOBI_CASES = {
    "dense": (64, 0.5, 1, dict(tolerance=1e-5, max_iterations=500)),
    "omega_0.7": (32, 0.3, 2, dict(tolerance=1e-5, max_iterations=2000,
                                   omega=0.7)),
    "substep_3": (48, 0.4, 5, dict(tolerance=1e-5, max_iterations=300,
                                   substep=3)),
    "capped": (16, 0.4, 3, dict(tolerance=1e-30, max_iterations=7)),
}


@pytest.mark.parametrize("case", list(JACOBI_CASES))
def test_weighted_jacobi_matches_reference_and_numpy(case):
    n, scale, seed, kw = JACOBI_CASES[case]
    a, b = _dominant(n, scale, seed)
    ref = jx.weighted_jacobi(a, b, **kw)
    out = tp.weighted_jacobi(torch.tensor(a), torch.tensor(b), **kw)
    # the loop's counters are the reference's: checks, not iterations
    assert out.iterations == int(ref.iterations)
    if case == "capped":
        assert out.iterations == 7
    # f32 products summed in another order: 1e-5 of the solution's scale
    x_ref = np.asarray(ref.result)
    np.testing.assert_allclose(out.result.numpy(), x_ref, rtol=0,
                               atol=1e-5 * np.abs(x_ref).max())
    expected = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    if case != "capped":
        np.testing.assert_allclose(out.result.numpy(), expected, rtol=1e-3)
        assert float(out.diff) <= kw["tolerance"] or float(out.diff) == 0.0
    # the statistics of the last check, in the reference's f32 formula.
    # At convergence diff is a max of differences of a few ulps of x, so it
    # moves in steps of 2n * ulp(max|x|) / (|sum x1| + |sum x2|): held to
    # 1e-3 of itself plus 4 such steps; correlation within 1e-5
    step = 2 * n * float(np.spacing(np.float32(np.abs(x_ref).max()))) / (
        2 * abs(float(x_ref.sum())))
    np.testing.assert_allclose(float(out.diff), float(ref.diff), rtol=1e-3,
                               atol=4 * step)
    np.testing.assert_allclose(float(out.correlation),
                               float(ref.correlation), atol=1e-5)


def test_weighted_jacobi_without_a_check():
    a, b = _dominant(16, 0.4, 3)
    x0 = np.arange(16, dtype=np.float32)
    ref = jx.weighted_jacobi(a, b, x0, max_iterations=0)
    out = tp.weighted_jacobi(a, b, x0, max_iterations=0, device="cpu")
    assert out.iterations == int(ref.iterations) == 0
    assert float(out.correlation) == float(ref.correlation) == 0.0
    assert float(out.diff) == float(ref.diff) == np.inf
    np.testing.assert_array_equal(out.result.numpy(), x0)


def test_reference_smoke_test_diagonal():
    """fusionsim.js:35-67: a 16x16 random diagonal system to 1e-3, through
    both packages' SOR wrappers."""
    rng = np.random.default_rng(0)
    a = np.zeros((16, 16), np.float32)
    d = rng.random(16).astype(np.float32) + 0.1
    np.fill_diagonal(a, d)
    b = rng.random(16).astype(np.float32)
    params = {"tolerance": 1e-3, "substep": 1, "max_iterations": 100}
    ref = jx.make_sor_iterative({"n_power": 1, "relaxation": 1.0})
    eq = tp.make_sor_iterative({"n_power": 1, "relaxation": 1.0},
                               device="cpu")
    assert (eq.vec_length, eq.vec_height) == (ref.vec_length,
                                              ref.vec_height) == (16, 2)
    r_ref = ref.set_matrix(a).set_b(b).solve(params)
    r_out = eq.set_matrix(a).set_b(b).solve(params)
    assert isinstance(r_out["correlation"], float)
    assert isinstance(r_out["diff"], float)
    assert type(r_out["iterations"]) is int
    assert r_out["iterations"] == r_ref["iterations"]
    assert r_out["diff"] <= 1e-3
    # a diagonal system: one iteration is exact, b / d in f32
    np.testing.assert_allclose(r_out["result"].numpy(), b / d, rtol=1e-6)
    np.testing.assert_array_equal(eq.x_result().numpy(),
                                  r_out["result"].numpy())


def test_sor_iterative_surface_matches_reference():
    """set_matrix/set_b/init_vector chain, mv_product, solve from a
    carried x, relaxation 0.8."""
    a, b = _dominant(64, 0.3, 7)   # n_power 2: 4 * 4^2 = 64
    x0 = np.linspace(-1, 1, 64).astype(np.float32)
    ref = jx.SORIterative(2, relaxation=0.8)
    eq = tp.SORIterative(2, relaxation=0.8, device="cpu")
    assert eq.set_matrix(a) is eq and eq.set_b(b[:, None]) is eq
    assert eq.init_vector(x0) is eq
    ref.set_matrix(a).set_b(b[:, None]).init_vector(x0)
    np.testing.assert_array_equal(eq.x_result().numpy(), x0)
    for _ in range(3):
        m_ref = np.asarray(ref.mv_product())
        m_out = eq.mv_product().numpy()
        np.testing.assert_allclose(m_out, m_ref, rtol=0,
                                   atol=1e-6 * np.abs(m_ref).max())
    params = {"tolerance": 1e-5, "substep": 2, "max_iterations": 50}
    r_ref = ref.solve(params)
    r_out = eq.solve(params)
    assert r_out["iterations"] == r_ref["iterations"]
    np.testing.assert_allclose(r_out["result"].numpy(),
                               np.asarray(r_ref["result"]), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(
                                   r_ref["result"])).max())
    np.testing.assert_allclose(r_out["correlation"], r_ref["correlation"],
                               atol=1e-5)


def test_sor_iterative_validation():
    eq = tp.SORIterative(1, device="cpu")
    with pytest.raises(ValueError, match=r"matrix must be \(16, 16\)"):
        eq.set_matrix(np.eye(8, dtype=np.float32))
    eq.set_matrix(np.eye(16, dtype=np.float32)).set_b(np.ones(16))
    with pytest.raises(SpecError, match="tolerance"):
        eq.solve({"substep": 1})
    with pytest.raises(SpecError, match="substep"):
        eq.solve({"tolerance": 1e-3, "substep": "1"})
    with pytest.raises(SpecError, match="max_iterations"):
        eq.solve({"tolerance": 1e-3, "max_iterations": True})
    with pytest.raises(SpecError, match="n_power"):
        tp.make_sor_iterative({"relaxation": 1.0}, device="cpu")
    with pytest.raises(SpecError, match="relaxation"):
        tp.make_sor_iterative({"n_power": 1, "relaxation": "x"},
                              device="cpu")
    assert tp.make_sor_iterative({"n_power": 3}, device="cpu").omega == 1.0


def test_conjugate_gradient_matches_reference_and_numpy():
    rng = np.random.default_rng(4)
    n = 48
    m = rng.random((n, n)).astype(np.float32)
    a = m @ m.T + n * np.eye(n, dtype=np.float32)  # SPD
    b = rng.random(n).astype(np.float32)
    ref = jx.conjugate_gradient(a, b, tolerance=1e-6, max_iterations=500)
    out = tp.conjugate_gradient(torch.tensor(a), torch.tensor(b),
                                tolerance=1e-6, max_iterations=500)
    assert out.iterations == int(ref.iterations)
    expected = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(out.result.numpy(), expected, rtol=1e-3,
                               atol=1e-6)
    x_ref = np.asarray(ref.result)
    np.testing.assert_allclose(out.result.numpy(), x_ref, rtol=0,
                               atol=1e-5 * np.abs(x_ref).max())
    assert float(out.diff) <= 1e-6
    np.testing.assert_allclose(float(out.correlation), 1.0 - float(out.diff))
    # a capped run: the counters as the reference's, |r|/|b| above the bar
    ref = jx.conjugate_gradient(a, b, tolerance=1e-12, max_iterations=3)
    out = tp.conjugate_gradient(a, b, tolerance=1e-12, max_iterations=3,
                                device="cpu")
    assert out.iterations == int(ref.iterations) == 3
    np.testing.assert_allclose(float(out.diff), float(ref.diff), rtol=1e-3)


@pytest.mark.parametrize("shape,block", [((4, 4), (2, 2)),
                                         ((12, 20, 3), (3, 5)),
                                         ((16, 8), (16, 1))])
def test_block_reductions_match_reference(shape, block):
    f = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    mx = tr.block_max(torch.tensor(f), block).numpy()
    np.testing.assert_array_equal(mx, np.asarray(jr.block_max(
        jnp.asarray(f), block)))   # a maximum is exact
    av_ref = np.asarray(jr.block_avg(jnp.asarray(f), block))
    av = tr.block_avg(torch.tensor(f), block).numpy()
    # f32 means of at most 16 values, summed in another order
    np.testing.assert_allclose(av, av_ref, rtol=0, atol=1e-6)
    levels = 2 if shape[0] % 4 == 0 and shape[1] % 4 == 0 else 1
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:
        ps = tr.pyramid_sum(torch.tensor(f), levels).numpy()
        ps_ref = np.asarray(jr.pyramid_sum(jnp.asarray(f), levels))
        np.testing.assert_allclose(ps, ps_ref, rtol=0, atol=1e-5)


def test_block_reductions_reference_values_and_errors():
    f = torch.arange(16.0).reshape(4, 4)
    np.testing.assert_array_equal(tr.block_max(f, (2, 2)).numpy(),
                                  [[5, 7], [13, 15]])
    np.testing.assert_array_equal(tr.block_avg(f, (2, 2)).numpy(),
                                  [[2.5, 4.5], [10.5, 12.5]])
    np.testing.assert_allclose(tr.pyramid_sum(f, 2).numpy(),
                               [[float(f.sum())]])
    with pytest.raises(ValueError, match="not divisible"):
        tr.block_max(f, (3, 2))
    with pytest.raises(ValueError, match="not divisible"):
        tr.block_avg(torch.zeros(6, 5), (2, 2))
