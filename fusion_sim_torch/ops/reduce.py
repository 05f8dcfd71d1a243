"""Block reductions over 2D fields (port of ``fusion_sim_tpu/ops/reduce.py``).

Counterparts of the reference's block reductions ``webgl_max``/``webgl_avg``
(utilities.js:759-1001, dead code there; SURVEY.md U8/U9) and of the
solver's halving reduction pyramid (matrix_webgl.js:346-388, M6).  Each is
one reshape and one reduction on the field's device.
"""

from __future__ import annotations

import torch


def _blocks(field: torch.Tensor, block: tuple[int, int]) -> torch.Tensor:
    h, w = field.shape[:2]
    bh, bw = block
    if h % bh or w % bw:
        raise ValueError(f"field {tuple(field.shape)} not divisible by "
                         f"block {tuple(block)}")
    return field.reshape(h // bh, bh, w // bw, bw, *field.shape[2:])


def block_max(field: torch.Tensor, block: tuple[int, int]) -> torch.Tensor:
    """Per-block maximum; output (H/bh, W/bw, ...) — webgl_max's intent."""
    return torch.amax(_blocks(field, block), dim=(1, 3))


def block_avg(field: torch.Tensor, block: tuple[int, int]) -> torch.Tensor:
    """Per-block average — webgl_avg's intent."""
    return torch.mean(_blocks(field, block), dim=(1, 3))


def pyramid_sum(field: torch.Tensor, levels: int) -> torch.Tensor:
    """Successive 2x2 adjacent sums, ``levels`` times (the M6 pyramid)."""
    out = field
    for _ in range(levels):
        out = block_avg(out, (2, 2)) * 4.0
    return out
