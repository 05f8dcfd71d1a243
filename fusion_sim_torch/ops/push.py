"""Position drift, sink absorption and Monte-Carlo respawn (port of
``fusion_sim_tpu/ops/push.py``).

``step_position_frag`` (empic.js:692-726): drift x+ = x + (dt*c) * v,
sample the sink mask at (r, z) (NEAREST); a particle with sink > 0.5
survives with alive = 1, otherwise it respawns at (r', 0, z') drawn from
the inverse-CDF table with this substep's two uniforms, with alive = 0 so
that the next substep's velocity pass re-initializes it thermally
(empic.js:719, 771-772).  Velocity is left untouched here.
"""

from __future__ import annotations

import torch

from .boris import gather_nearest
from .interp import spill_rows_cond
from .sampling import sample_inverse_cdf


def push_position(position: torch.Tensor, velocity: torch.Tensor,
                  rand: torch.Tensor, sink_mask: torch.Tensor,
                  inv_cdf_table: torch.Tensor, step_factor: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One drift + sink/respawn pass: ``position``/``velocity`` (N, 3)
    normalized, ``rand`` (N, >=2) uniforms, ``sink_mask`` (nr, nz) with
    1 = keep, ``inv_cdf_table`` (512, 512, 2), ``step_factor`` = dt * c.
    Returns (next_position, next_alive)."""
    next_pos = position + step_factor * velocity
    x, y, z = next_pos[..., 0], next_pos[..., 1], next_pos[..., 2]
    r = torch.sqrt(x * x + y * y)
    sink = gather_nearest(sink_mask[..., None], r, z)[..., 0]
    pos, alive, _ = sink_respawn(next_pos, sink, rand, inv_cdf_table)
    return pos, alive


def sink_respawn(next_pos: torch.Tensor, sink: torch.Tensor,
                 rand: torch.Tensor, inv_cdf_table: torch.Tensor,
                 respawn_capacity: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The gather-free half of ``push_position``: apply a pre-sampled sink
    value per particle.  Returns ``(position, alive, n_dropped)``.

    ``respawn_capacity``: the inverse-CDF lookup runs only on the first
    ``respawn_capacity`` respawning rows (in row order) instead of all N —
    the same result for every respawned row.  Rows past the capacity keep
    their drifted position with alive = 0 and are re-absorbed next
    substep; ``n_dropped = max(n_respawning - capacity, 0)`` counts them
    (0 without a capacity).  With a capacity the respawn count is read on
    the host once (it sizes the compaction)."""
    x, y, z = next_pos[..., 0], next_pos[..., 1], next_pos[..., 2]
    keep = sink > 0.5
    alive = keep.to(torch.float32)
    if respawn_capacity is None:
        new_r, new_z = sample_inverse_cdf(inv_cdf_table, rand[..., 0],
                                          rand[..., 1])
        out = torch.stack([torch.where(keep, x, new_r),
                           torch.where(keep, y, 0.0),
                           torch.where(keep, z, new_z)], dim=-1)
        return out, alive, 0
    mask = ~keep
    n_respawn = int(mask.sum())
    k = min(n_respawn, respawn_capacity)
    out = next_pos.clone()
    if k:
        idx = spill_rows_cond(mask, n_respawn, respawn_capacity,
                              mask.shape[0])[0][:k]
        new_r, new_z = sample_inverse_cdf(inv_cdf_table, rand[idx, 0],
                                          rand[idx, 1])
        out[idx] = torch.stack([new_r, torch.zeros_like(new_r), new_z],
                               dim=-1)
    return out, alive, max(n_respawn - respawn_capacity, 0)
