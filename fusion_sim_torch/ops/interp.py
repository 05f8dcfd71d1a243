"""Particle <-> grid interpolation: cloud-in-cell (CIC) deposit and gather.

Port of ``fusion_sim_tpu/ops/interp.py``: first-order CIC kernels over
periodic grids of any rank, with grid values at integer nodes.  The packed
forms keep the reference's arithmetic (the deposit: one base-cell row per
particle with the 2^d corners in channels, rolled back afterwards; the
gather: the 2^d corner values summed in the same order), so the two
packages agree to f32 rounding; on the card they run as PyTorch
scatter/gather kernels, which is all the spill patch and the diagnostics
need.
"""

from __future__ import annotations

import itertools
import math

import torch

from .._device import device_const
from ..utils.profiling import span


def _strides(shape: tuple[int, ...], device) -> torch.Tensor:
    """Row-major flattening strides for ``shape``."""
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return device_const(out[::-1], device, torch.int64)


def _corner_weights(position: torch.Tensor):
    """Base cell index (N, d) int64 and CIC fractions (N, d), position's
    dtype; ``position`` is in grid units."""
    base = torch.floor(position)
    return base.to(torch.int64), position - base


def _corners(n_dim: int):
    return list(itertools.product((0, 1), repeat=n_dim))


def _corner_weight(frac: torch.Tensor, corner, start):
    w = start
    for axis, c in enumerate(corner):
        w = w * (frac[:, axis] if c == 1 else 1.0 - frac[:, axis])
    return w


def cic_deposit(position: torch.Tensor, weights: torch.Tensor,
                shape: tuple[int, ...]) -> torch.Tensor:
    """Deposit per-particle ``weights`` (N,) at ``position`` (N, d) onto a
    periodic grid of ``shape`` with CIC shapes; returns the summed grid."""
    base, frac = _corner_weights(position)
    dims = device_const(shape, position.device, torch.int64)
    strides = _strides(shape, position.device)
    flat = torch.zeros(math.prod(shape), dtype=weights.dtype,
                       device=weights.device)
    for corner in _corners(len(shape)):
        offs = device_const(corner, position.device, torch.int64)
        idx = torch.remainder(base + offs, dims)
        flat.index_add_(0, (idx * strides).sum(1),
                        _corner_weight(frac, corner, weights))
    return flat.reshape(shape)


def cic_gather(grid: torch.Tensor, position: torch.Tensor,
               shape: tuple[int, ...]) -> torch.Tensor:
    """Gather ``grid`` ((*shape) or (*shape, C)) at particle positions with
    the same CIC shapes; returns (N,) or (N, C)."""
    base, frac = _corner_weights(position)
    channels = grid.shape[len(shape):]
    flat = grid.reshape((-1,) + tuple(channels))
    dims = device_const(shape, position.device, torch.int64)
    strides = _strides(shape, position.device)
    out = 0.0
    for corner in _corners(len(shape)):
        offs = device_const(corner, position.device, torch.int64)
        idx = torch.remainder(base + offs, dims)
        w = _corner_weight(
            frac, corner,
            torch.ones(position.shape[0], dtype=grid.dtype,
                       device=grid.device))
        if channels:
            w = w[:, None]
        out = out + w * flat[(idx * strides).sum(1)]
    return out


def cic_deposit_packed(position: torch.Tensor, weights: torch.Tensor,
                       shape: tuple[int, ...]) -> torch.Tensor:
    """CIC deposit with a single scatter-add row per particle (exact)."""
    corners = _corners(len(shape))
    base, frac = _corner_weights(position)
    base = torch.remainder(base,
                           device_const(shape, position.device, torch.int64))
    flat_idx = (base * _strides(shape, position.device)).sum(1)
    packed_vals = torch.stack(
        [_corner_weight(frac, c, weights) for c in corners], dim=-1)
    packed = torch.zeros((math.prod(shape), len(corners)),
                         dtype=weights.dtype, device=weights.device)
    packed.index_add_(0, flat_idx, packed_vals)
    packed = packed.reshape(*shape, len(corners))
    out = torch.zeros(shape, dtype=weights.dtype, device=weights.device)
    for k, corner in enumerate(corners):
        shifts = [a for a, c in enumerate(corner) if c]
        contrib = packed[..., k]
        if shifts:
            contrib = torch.roll(contrib, [1] * len(shifts), shifts)
        out = out + contrib
    return out


def cic_gather_packed(grid: torch.Tensor, position: torch.Tensor,
                      shape: tuple[int, ...]) -> torch.Tensor:
    """CIC gather with a single gather row per particle (exact).

    ``grid``: (*shape,) or (*shape, C); returns (N,) or (N, C).  The
    reference reads each particle's base-cell row of a table holding the
    2^d corner values (the grid rolled once a corner); the port reads the
    same corner values straight from the grid at the wrapped corner
    indices, and sums them with the same weights in the same corner order,
    so the result is the same to the bit with work in the particles only
    (a spill patch of a few rows does not pay for the whole grid)."""
    n_dim = len(shape)
    channels = tuple(grid.shape[n_dim:])
    flat = grid.reshape(-1, math.prod(channels) if channels else 1)
    base, frac = _corner_weights(position)
    stride = [math.prod(shape[a + 1:]) for a in range(n_dim)]
    # per axis: the wrapped base cell and the cell after it
    cells = []
    for a, n in enumerate(shape):
        b0 = torch.remainder(base[:, a], n)
        cells.append((b0, torch.remainder(b0 + 1, n)))
    ones = torch.ones(position.shape[0], dtype=grid.dtype,
                      device=grid.device)
    out = 0.0
    for corner in _corners(n_dim):
        idx = sum(cells[a][c] * stride[a] for a, c in enumerate(corner))
        w = _corner_weight(frac, corner, ones)
        out = out + w[:, None] * flat[idx]
    if channels:
        return out.reshape((position.shape[0],) + channels)
    return out[:, 0]


def spill_rows(spill_mask: torch.Tensor, spill, capacity: int,
               n_total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact up to ``capacity`` spilled-row indices for an exact patch.

    The contract of the reference: the indices of the first ``capacity``
    rows set in ``spill_mask``, in row order, with the sentinel
    ``n_total`` in the tail.  Returns ``(idx (capacity,) int64,
    ok (capacity,) bool)`` with ``ok = arange(capacity) < spill``."""
    idx = torch.nonzero_static(spill_mask, size=capacity,
                               fill_value=n_total)[:, 0]
    ok = torch.arange(capacity, device=spill_mask.device) < spill
    return idx, ok


def patch_rows(mask: torch.Tensor, capacities: tuple[int, ...],
               count: torch.Tensor | None = None
               ) -> tuple[int, torch.Tensor]:
    """The rows of ``mask`` that take the exact patch: ``(count, idx)``.

    ``count`` is the number of rows set in ``mask``, read on the host once
    (the ``host_read`` span), from ``count`` where the caller already has
    it on the device; ``idx`` holds the first min(count, capacities[-1])
    of them in row order, compacted at the smallest of the ascending
    ``capacities`` that covers them (a buffer size only: every capacity
    yields the same rows), and is empty when there is nothing to patch."""
    with span("host_read"):
        n = int(mask.sum() if count is None else count)
    k = min(n, capacities[-1])
    if not k:
        return n, torch.empty((0,), dtype=torch.int64, device=mask.device)
    cap = next(c for c in capacities if k <= c)
    return n, spill_rows(mask, n, cap, mask.shape[0])[0][:k]


def spill_rows_cond(spill_mask: torch.Tensor, spill, capacity: int,
                    n_total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``spill_rows`` that skips the O(N) compaction when ``spill`` is 0.

    PyTorch runs eagerly, so the reference's ``lax.cond`` becomes a host
    branch on the spill count (one device read when ``spill`` is a
    tensor).  Same contract: ``ok = idx < n_total``."""
    if int(spill) > 0:
        idx = spill_rows(spill_mask, spill, capacity, n_total)[0]
    else:
        idx = torch.full((capacity,), n_total, dtype=torch.int64,
                         device=spill_mask.device)
    return idx, idx < n_total
