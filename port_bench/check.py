"""The comparisons that decide ``correct``, common to every kind.

The reference follows the program step by step from the program's own
state: the layout's maintenance (resort, repair) permutes the rows, so
two sets of particles are compared through their moments, deposited by
the reference with CIC onto the grid: the count of particles (weight 1)
and each velocity component (weight v) at every node.  Per channel the
gap is the largest difference at a node over the largest magnitude of
the reference's channel; a set's gap is its worst channel's.  A particle
moved by a few thousandths of a cell, or a velocity off in its fourth
digit, shows in them; float32 rounding does not.
"""

from __future__ import annotations

import torch

from .reference import pic


def moments(x: torch.Tensor, v: torch.Tensor, shape) -> torch.Tensor:
    """(*shape, 1 + v components) grid: particle count and velocity sums
    deposited at the wrapped positions ``x`` (in blocks of rows, so that
    it adds little to the device's peak)."""
    grid = 0.0
    for lo in range(0, x.shape[0], pic.ROWS):
        vb = v[lo:lo + pic.ROWS].float()
        w = torch.cat([torch.ones((vb.shape[0], 1), dtype=torch.float32,
                                  device=vb.device), vb], dim=1)
        grid = grid + pic.deposit(x[lo:lo + pic.ROWS], w, shape)
    return grid


def gap(candidate: torch.Tensor, reference: torch.Tensor) -> float:
    """Worst channel's max |candidate - reference| over max |reference|;
    both (..., C) with channels last.  1.0 where the candidate is not
    finite."""
    c = candidate.float().reshape(-1, candidate.shape[-1])
    r = reference.float().reshape(-1, reference.shape[-1])
    if not bool(torch.isfinite(c).all()):
        return 1.0
    diff = (c - r).abs().amax(dim=0)
    scale = r.abs().amax(dim=0).clamp_min(torch.finfo(torch.float32).tiny)
    return float((diff / scale).max())


def rows_gap(cand: dict, ref_x: torch.Tensor, ref_v: torch.Tensor,
             shape, n_real: int) -> dict[str, float]:
    """``count`` (real rows off N, and off the reference's) and
    ``moments`` of a candidate's rows against the reference's."""
    count = abs(cand["x"].shape[0] - n_real) + abs(ref_x.shape[0] - n_real)
    if cand["x"].shape[0] != ref_x.shape[0]:
        return {"count": float(count), "moments": 1.0}
    return {"count": float(count),
            "moments": gap(moments(cand["x"], cand["v"], shape),
                           moments(ref_x, ref_v, shape))}


def nonfinite(snap: dict) -> int:
    """Non-finite values in a snapshot's tensors."""
    return sum(int((~torch.isfinite(t)).sum()) for t in snap.values()
               if torch.is_tensor(t) and t.is_floating_point())
