"""Spectral Poisson solve on periodic grids (port of the spectral half of
``fusion_sim_tpu/ops/solvers.py``).

``poisson_fft`` is the field solve of the ES PIC loop; on the card
``torch.fft`` runs it through cuFFT.  ``poisson_dft2d`` (the reference's
dense-DFT matmul form, a workaround for the TPU's emulated FFT) is kept
only so the tests can hold both forms against each other.
"""

from __future__ import annotations

import functools
import math

import torch


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
