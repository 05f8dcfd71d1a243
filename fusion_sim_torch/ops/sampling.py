"""Monte-Carlo source sampling by a tabulated inverse CDF (port of
``fusion_sim_tpu/ops/sampling.py``).

The reference builds a marginal CDF over r and per-row conditional CDFs
over z from a 2D source PDF and tabulates a 512x512 inverse-CDF lookup
(f1, f2) -> (r, z) (empic.js:1263-1341); respawned particles sample it
with two uniforms (empic.js:712-717).  Cumulative sums plus a batched
``torch.searchsorted`` reproduce the linear-interpolated inverse; the
reference's ``vmap`` over rows becomes the batch axis of the search.
"""

from __future__ import annotations

import torch

INV_CDF_SIZE = 512  # empic.js:228-241 — 512x512 lookup table


def _inverse_interp(cdf: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Inverse of a discrete CDF with the reference's interpolation
    (``inverse_cdf_x``, empic.js:1296-1311): the first index i with
    cdf[i] >= f, then (i + (f - cdf[i-1]) / (cdf[i] - cdf[i-1])) / n.

    ``cdf`` (..., n) ascending along its last axis; ``f`` (m,) for a 1-D
    ``cdf``, else (..., m) with the same leading axes.  At f == 0 the
    reference divides 0/0 where the CDF has leading zeros; the limit
    f -> 0+ is taken instead (the first cell with mass)."""
    n = cdf.shape[-1]
    f = torch.clamp(f, min=1e-30)
    i = torch.clamp(torch.searchsorted(cdf, f, side="left"), max=n - 1)
    prev = torch.where(i > 0, torch.gather(cdf, -1, torch.clamp(i - 1, min=0)),
                       0.0)
    denom = torch.gather(cdf, -1, i) - prev
    frac = torch.where(denom > 0, (f - prev) / denom, 0.0)
    return (i.to(torch.float32) + frac) / n


def build_inverse_cdf_table(source_pdf, size: int = INV_CDF_SIZE,
                            device=None) -> torch.Tensor:
    """The inverse CDF of a 2D source PDF ``(nr, nz)`` (non-negative
    weights) as a ``(size, size, 2)`` table: entry [i, j] = (r, z) in
    [0, 1)^2 for the quantiles f1 = i/(size-1), f2 = j/(size-1)
    (empic.js:1325-1341)."""
    pdf = torch.as_tensor(source_pdf, dtype=torch.float32, device=device)
    dev = pdf.device
    nr, nz = pdf.shape
    row_sums = torch.sum(pdf, dim=1)
    cdf_x = torch.cumsum(row_sums, 0)
    cdf_x = cdf_x / cdf_x[-1]

    # empty rows would make the conditional CDF 0/0; a uniform ramp stands
    # in (such rows are only reachable at quantile-1 boundaries)
    totals = torch.cumsum(pdf, dim=1)
    ramp = (torch.arange(nz, dtype=torch.float32, device=dev) + 1.0) / nz
    safe = torch.where(row_sums == 0, 1.0, row_sums)
    cdf_y = torch.where(row_sums[:, None] > 0, totals / safe[:, None],
                        ramp[None, :])

    f = torch.arange(size, dtype=torch.float32, device=dev) / (size - 1)
    x = _inverse_interp(cdf_x, f)
    rows = torch.clamp((x * nr).to(torch.int64), max=nr - 1)   # empic.js:1314
    # quantile-1 boundary: step back onto the last row with mass
    rows = torch.where(row_sums[rows] > 0, rows, torch.clamp(rows - 1, min=0))
    y = _inverse_interp(cdf_y[rows], f.expand(size, size).contiguous())
    return torch.stack([x[:, None].expand(size, size), y], dim=-1)


def sample_inverse_cdf(table: torch.Tensor, u1: torch.Tensor,
                       u2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NEAREST lookup of the inverse-CDF table with two uniforms per
    particle (``texture2D(u_inv_cdf, rand.xy)``, empic.js:716)."""
    size = table.shape[0]
    i = torch.clamp(torch.floor(u1 * size).to(torch.int64), 0, size - 1)
    j = torch.clamp(torch.floor(u2 * size).to(torch.int64), 0, size - 1)
    picked = table[i, j]
    return picked[..., 0], picked[..., 1]
