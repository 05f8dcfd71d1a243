"""Port vs reference: spectral Poisson solve and field gradient
(fusion_sim_torch/ops/solvers.py, models/electrostatic.solve_fields)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_sim_torch.models import electrostatic as tes
from fusion_sim_torch.ops import solvers as tp
from fusion_sim_tpu.models import electrostatic as jes
from fusion_sim_tpu.ops import solvers as jx


def _rho(shape, seed=0):
    rho = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return rho - rho.mean()


@pytest.mark.parametrize("shape,dx", [((64,), (0.1,)),
                                      ((32, 48), (0.1, 0.2)),
                                      ((8, 12, 16), (0.3, 0.2, 0.1))])
def test_poisson_fft_and_gradient_match_reference(shape, dx):
    rho = _rho(shape)
    phi_j = np.asarray(jx.poisson_fft(jnp.asarray(rho), dx, eps0=1.5))
    phi_t = tp.poisson_fft(torch.tensor(rho), dx, eps0=1.5).numpy()
    # both are f32 FFTs of the same data; pocketfft vs torch's FFT differ
    # by O(log n) roundings relative to the largest mode: 1e-6 of max|phi|
    scale = np.abs(phi_j).max()
    np.testing.assert_allclose(phi_t, phi_j, rtol=0, atol=1e-6 * scale)
    gj = jx.gradient_periodic(jnp.asarray(phi_j), dx)
    gt = tp.gradient_periodic(torch.tensor(phi_j), dx)
    for a, b in zip(gj, gt):
        # same rolls and the same f32 difference: exact up to 1e-6
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_poisson_dft2d_matches_fft():
    shape, dx = (32, 48), (0.1, 0.2)
    rho = torch.tensor(_rho(shape, seed=3))
    phi_f = tp.poisson_fft(rho, dx)
    for precision in ("highest", "exact_bf16"):
        phi_d = tp.poisson_dft2d(rho, dx, precision=precision)
        # dense O(n^3) f32 matmuls vs FFT: ~n f32 roundings per entry
        np.testing.assert_allclose(phi_d.numpy(), phi_f.numpy(), rtol=0,
                                   atol=1e-5 * float(phi_f.abs().max()))
    with pytest.raises(ValueError):
        tp.poisson_dft2d(rho, dx, precision="tf32")


def test_solve_fields_matches_reference_dft_route():
    """The reference solves 2D grids <= 2048^2 with its dense-DFT matmul
    form; the port always uses the FFT.  The reference's docstring states
    ~1e-5 relative between the two routes; that holds for phi.  E is a
    central difference of phi, which amplifies the DFT route's own f32
    error: against a float64 solve it is ~2.8e-5 of max|E| at 64^2, while
    the port's FFT stays within 1e-6 (ROADMAP Queue C)."""
    cells = 64
    length = 2 * np.pi
    d = length / cells
    kw = dict(grid_shape=(cells, cells), cell_size=(d, d), dt=0.05,
              charge=-1e-3, mass=1e-3)
    rho = _rho((cells, cells), seed=5)
    phi_j, e_j = jes.solve_fields(jes.ESConfig(**kw), jnp.asarray(rho))
    phi_t, e_t = tes.solve_fields(tes.ESConfig(**kw), torch.tensor(rho))
    phi_64, e_64 = tes.solve_fields(tes.ESConfig(**kw),
                                    torch.tensor(rho, dtype=torch.float64))
    for got, ref, exact, tol in ((phi_t, phi_j, phi_64, 1e-5),
                                 (e_t, e_j, e_64, 5e-5)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        scale = np.abs(exact.numpy()).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tol * scale)
        # the port's FFT route is the accurate one: f32 rounding only
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0,
                                   atol=2e-6 * scale)
