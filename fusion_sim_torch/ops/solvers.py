"""Linear and spectral solvers (port of ``fusion_sim_tpu/ops/solvers.py``
but for the sharded spectral solve).

* ``weighted_jacobi`` / ``SORIterative`` / ``make_sor_iterative`` — the
  reference's iterative solver (``makeSORIterative``,
  matrix_webgl.js:35-711): x+ = omega*(R x + C) + (1-omega)*x with
  R = -A_offdiag/diag(A), C = b/diag(A) (programR/programC,
  matrix_webgl.js:224-305), and the host loop's convergence statistics
  (Pearson correlation of successive iterates, the relative max-diff stop
  test, matrix_webgl.js:646-691).  The reference runs a ``lax.while_loop``;
  here a Python loop runs ``substep`` iterations on the device between
  checks and reads ``diff`` once a check.
* ``conjugate_gradient`` — dense-SPD CG, one host read of ``|r|`` an
  iteration.
* ``poisson_fft`` — the field solve of the ES PIC loop; on the card
  ``torch.fft`` runs it through cuFFT.  ``poisson_dft2d`` (the reference's
  dense-DFT matmul form, a workaround for the TPU's emulated FFT) is kept
  only so the tests can hold both forms against each other.

Every product runs in f32 with TF32 off (``precision.f32_matmul``), as
the reference computes it.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from .precision import f32_matmul


class SolveResult(NamedTuple):
    """Parity with the reference's solve() return object
    (matrix_webgl.js:693-698)."""

    correlation: torch.Tensor  # Pearson correlation of the last two iterates
    diff: torch.Tensor         # relative max-diff at the last check
    iterations: int            # convergence checks taken
    result: torch.Tensor       # the solution vector


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _solve_device(a, device) -> torch.Tensor:
    """The device a solve runs on: ``device`` if given, else the matrix's
    when it is a tensor, else the card."""
    if device is None and isinstance(a, torch.Tensor):
        return a.device
    return resolve_device(device)


def _jacobi_stats(x1: torch.Tensor, x2: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pearson correlation + the reference's relative-diff stop metric
    (matrix_webgl.js:676-683): diff = 2*n*max|x2-x1| / (|sum x1| + |sum
    x2|).  f32, in the reference's formula and order."""
    n = x1.shape[0]
    s1, s2 = torch.sum(x1), torch.sum(x2)
    s11 = torch.sum(x1 * x1)
    s22 = torch.sum(x2 * x2)
    s12 = torch.sum(x1 * x2)
    denom = torch.sqrt((n * s11 - s1 * s1) * (n * s22 - s2 * s2))
    correlation = torch.where(denom > 0, (n * s12 - s1 * s2) / denom, 1.0)
    max_diff = torch.max(torch.abs(x2 - x1))
    diff = 2.0 * n * max_diff / (torch.abs(s1) + torch.abs(s2))
    return correlation, diff


def weighted_jacobi(a, b, x0=None, *, tolerance: float = 1e-3,
                    max_iterations: int = 100, substep: int = 1,
                    omega: float = 1.0, device=None) -> SolveResult:
    """Weighted-Jacobi solve of A x = b on the device.

    Iteration (programR/programC/programResult, matrix_webgl.js:224-424):
        x+ = omega * (R x + C) + (1 - omega) * x

    ``substep`` iterations run between convergence checks, like the
    reference's substep parameter (matrix_webgl.js:648-662).  The loop runs
    while ``iterations < max_iterations and diff > tolerance``; ``diff``
    starts at +inf, ``iterations`` counts checks, and ``correlation`` is 0
    when no check ran.  ``device`` None means the matrix's device when it
    is a tensor, else the card."""
    dev = _solve_device(a, device)
    a = _as_f32(a, dev)
    b = _as_f32(b, dev)
    x = torch.zeros_like(b) if x0 is None else _as_f32(x0, dev)
    d = torch.diagonal(a)
    inv_d = 1.0 / d
    r = -(a - torch.diag(d)) * inv_d[:, None]  # row-scaled off-diagonal
    c = b * inv_d
    omega = torch.tensor(omega, dtype=torch.float32, device=dev)
    # the reference compares an f32 diff with the tolerance as f32
    tol = float(np.float32(tolerance))
    correlation = torch.zeros((), dtype=torch.float32, device=dev)
    diff = torch.full((), math.inf, dtype=torch.float32, device=dev)
    it, diff_host = 0, math.inf
    with f32_matmul():
        while it < max_iterations and diff_host > tol:
            x_prev = x
            for _ in range(substep):
                x = omega * (r @ x + c) + (1.0 - omega) * x
            correlation, diff = _jacobi_stats(x_prev, x)
            it += 1
            diff_host = float(diff)   # one host read a check
    return SolveResult(correlation=correlation, diff=diff, iterations=it,
                       result=x)


class SORIterative:
    """API-parity wrapper mirroring ``makeSORIterative``
    (matrix_webgl.js:35-711): ``vec_length``/``vec_height`` sizing from
    ``n_power`` (vector length = 4*(2^n_power)^2, matrix_webgl.js:44-54),
    chainable ``set_matrix``/``set_b``/``init_vector``, ``mv_product``,
    ``solve`` and ``x_result``.  ``device`` None means the card."""

    def __init__(self, n_power: int, relaxation: float = 1.0, device=None):
        self.device = resolve_device(device)
        self.vec_height = 2 ** n_power
        self.vec_length = 4 * self.vec_height * self.vec_height
        self.omega = relaxation
        self._a = None
        self._b = None
        self._x = torch.zeros((self.vec_length,), dtype=torch.float32,
                              device=self.device)

    def set_matrix(self, matrix) -> "SORIterative":
        a = _as_f32(matrix, self.device)
        if tuple(a.shape) != (self.vec_length, self.vec_length):
            raise ValueError(
                f"matrix must be ({self.vec_length}, {self.vec_length}), "
                f"got {tuple(a.shape)}")
        self._a = a
        return self

    def set_b(self, b) -> "SORIterative":
        self._b = _as_f32(b, self.device).reshape(self.vec_length)
        return self

    def init_vector(self, vector) -> "SORIterative":
        self._x = _as_f32(vector, self.device).reshape(self.vec_length)
        return self

    def mv_product(self) -> torch.Tensor:
        """One iteration application x -> omega*(R x + C) + (1-omega)*x
        (out.mv_product, matrix_webgl.js:539-562)."""
        d = torch.diagonal(self._a)
        r = -(self._a - torch.diag(d)) / d[:, None]
        c = self._b / d
        with f32_matmul():
            self._x = (self.omega * (r @ self._x + c)
                       + (1 - self.omega) * self._x)
        return self._x

    def solve(self, params: dict) -> dict:
        """Parity with out.solve (matrix_webgl.js:571-700): a dict with
        correlation and diff (floats), iterations (int) and result."""
        from ..config import Optional, validate_object

        validate_object(params, {
            "tolerance": "number",
            "substep": Optional("number"),
            "max_iterations": Optional("number"),
        })
        out = weighted_jacobi(
            self._a, self._b, self._x,
            tolerance=float(params["tolerance"]),
            max_iterations=int(params.get("max_iterations", 100)),
            substep=int(params.get("substep", 1)),
            omega=self.omega, device=self.device)
        self._x = out.result
        return {
            "correlation": float(out.correlation),
            "diff": float(out.diff),
            "iterations": out.iterations,
            "result": out.result,
        }

    def x_result(self) -> torch.Tensor:
        """Current solution (x_result_tex, matrix_webgl.js:703-706)."""
        return self._x


def make_sor_iterative(spec: dict, device=None) -> SORIterative:
    """Factory with the reference's spec validation (matrix_webgl.js:36-40)."""
    from ..config import Optional, validate_object

    validate_object(spec, {"n_power": "number",
                           "relaxation": Optional("number")})
    return SORIterative(int(spec["n_power"]),
                        float(spec.get("relaxation", 1.0)), device=device)


def conjugate_gradient(a, b, x0=None, *, tolerance: float = 1e-6,
                       max_iterations: int = 1000,
                       device=None) -> SolveResult:
    """Dense-SPD conjugate gradient.  Stops when ``|r|/|b| <= tolerance``
    (|b| floored at 1e-30) or after ``max_iterations``; returns
    ``correlation = 1 - rel`` and ``diff = rel``, as the reference does.
    One host read of ``|r|`` an iteration."""
    dev = _solve_device(a, device)
    a = _as_f32(a, dev)
    b = _as_f32(b, dev)
    x = torch.zeros_like(b) if x0 is None else _as_f32(x0, dev)
    tol = float(np.float32(tolerance))
    with f32_matmul():
        r = b - a @ x
        p = r
        rs = torch.dot(r, r)
        bnorm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
        rel = torch.linalg.vector_norm(r) / bnorm
        it = 0
        while it < max_iterations and float(rel) > tol:
            ap = a @ p
            alpha = rs / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / rs) * p
            rs = rs_new
            it += 1
            rel = torch.linalg.vector_norm(r) / bnorm
    return SolveResult(correlation=1.0 - rel, diff=rel, iterations=it,
                       result=x)


@functools.lru_cache(maxsize=8)
def _inv_ksq(shape: tuple[int, ...], dx: tuple[float, ...], eps0: float,
             device: torch.device) -> torch.Tensor:
    """1/(eps0 |k|^2) on the rfft grid of ``shape`` (k=0 mode zeroed), f32
    like the reference.  Cached per grid: the solve runs every step and the
    grid never changes; callers never write to the result."""
    ks = [2 * math.pi * torch.fft.fftfreq(n, d=d, device=device)
          for n, d in zip(shape[:-1], dx[:-1])]
    ks.append(2 * math.pi * torch.fft.rfftfreq(shape[-1], d=dx[-1],
                                               device=device))
    grids = torch.meshgrid(*ks, indexing="ij")
    ksq = sum(g * g for g in grids)
    return torch.where(ksq > 0, 1.0 / (eps0 * ksq), 0.0)


def poisson_fft(rho: torch.Tensor, dx: tuple[float, ...],
                eps0: float = 1.0) -> torch.Tensor:
    """Solve laplacian(phi) = -rho/eps0 on a fully periodic grid.

    Spectral: phi_k = rho_k / (eps0 |k|^2), k=0 mode zeroed (the mean of
    phi is gauge).  Any rank; ``dx`` has one entry per axis."""
    inv = _inv_ksq(tuple(rho.shape), tuple(float(d) for d in dx),
                   float(eps0), rho.device)
    phi_k = torch.fft.rfftn(rho) * inv
    return torch.fft.irfftn(phi_k, s=rho.shape)


def poisson_dft2d(rho: torch.Tensor, dx: tuple[float, float],
                  eps0: float = 1.0, precision: str = "highest"
                  ) -> torch.Tensor:
    """``poisson_fft`` for 2D grids as explicit real DFT matmuls:
    phi = (1/N) Re[F^H (F rho F^T / (eps0 |k|^2)) F^*], F = C - iS.

    Every ``precision`` name runs in f32: the reference's bf16 splits were
    the TPU's route to f32 accuracy (ops/precision.py)."""
    from .precision import resolve_precision

    dtype = resolve_precision(precision)
    nx, ny = rho.shape
    dev = rho.device

    def cs(n):
        j = torch.arange(n, dtype=dtype, device=dev)
        th = (2.0 * math.pi / n) * torch.outer(j, j)
        return torch.cos(th), torch.sin(th)

    cx, sx = cs(nx)
    cy, sy = cs(ny)
    kx = 2 * math.pi * torch.fft.fftfreq(nx, d=dx[0], device=dev)
    ky = 2 * math.pi * torch.fft.fftfreq(ny, d=dx[1], device=dev)
    ksq = kx[:, None] ** 2 + ky[None, :] ** 2
    inv = torch.where(ksq > 0, 1.0 / (eps0 * ksq), 0.0) / (nx * ny)
    rho = rho.to(dtype)
    a_r = cx @ rho                      # forward x: A = (C - iS) rho
    a_i = -(sx @ rho)
    b_r = a_r @ cy.T + a_i @ sy.T       # forward y
    b_i = a_i @ cy.T - a_r @ sy.T
    p_r = b_r * inv
    p_i = b_i * inv
    q_r = cx.T @ p_r - sx.T @ p_i       # inverse x: e^{+i}
    q_i = cx.T @ p_i + sx.T @ p_r
    return q_r @ cy - q_i @ sy          # inverse y, real part


def gradient_periodic(phi: torch.Tensor, dx: tuple[float, ...]
                      ) -> tuple[torch.Tensor, ...]:
    """Central-difference gradient with periodic wrap; E = -grad(phi)."""
    return tuple(
        (torch.roll(phi, -1, axis) - torch.roll(phi, 1, axis)) / (2.0 * d)
        for axis, d in enumerate(dx))
