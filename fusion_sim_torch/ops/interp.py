"""Particle <-> grid interpolation: cloud-in-cell (CIC) deposit and gather.

Port of ``fusion_sim_tpu/ops/interp.py``: first-order CIC kernels over
periodic grids of any rank, with grid values at integer nodes.  The packed
forms keep the reference's arithmetic (one base-cell row per particle with
the 2^d corners in channels, rolled back afterwards), so the two packages
agree to f32 rounding; on the card they run as PyTorch scatter/gather
kernels, which is all the spill patch and the diagnostics need.
"""

from __future__ import annotations

import itertools
import math

import torch


def _strides(shape: tuple[int, ...], device) -> torch.Tensor:
    """Row-major flattening strides for ``shape``."""
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return torch.tensor(out[::-1], dtype=torch.int64, device=device)


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
    dims = torch.tensor(shape, dtype=torch.int64, device=position.device)
    strides = _strides(shape, position.device)
    flat = torch.zeros(math.prod(shape), dtype=weights.dtype,
                       device=weights.device)
    for corner in _corners(len(shape)):
        offs = torch.tensor(corner, dtype=torch.int64, device=position.device)
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
    dims = torch.tensor(shape, dtype=torch.int64, device=position.device)
    strides = _strides(shape, position.device)
    out = 0.0
    for corner in _corners(len(shape)):
        offs = torch.tensor(corner, dtype=torch.int64, device=position.device)
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
    base = torch.remainder(
        base, torch.tensor(shape, dtype=torch.int64, device=position.device))
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

    ``grid``: (*shape,) or (*shape, C); returns (N,) or (N, C)."""
    corners = _corners(len(shape))
    channels = tuple(grid.shape[len(shape):])
    c_width = math.prod(channels) if channels else 1
    blocks = []
    for corner in corners:
        shifts = [a for a, c in enumerate(corner) if c]
        shifted = (torch.roll(grid, [-1] * len(shifts), shifts) if shifts
                   else grid)
        blocks.append(shifted.reshape(-1, c_width))
    table = torch.cat(blocks, dim=-1)
    base, frac = _corner_weights(position)
    base = torch.remainder(
        base, torch.tensor(shape, dtype=torch.int64, device=position.device))
    rows = table[(base * _strides(shape, position.device)).sum(1)]
    out = 0.0
    for k, corner in enumerate(corners):
        w = _corner_weight(
            frac, corner,
            torch.ones(position.shape[0], dtype=grid.dtype,
                       device=grid.device))
        out = out + w[:, None] * rows[:, k * c_width:(k + 1) * c_width]
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
