"""Tile-sorted particle layout, 2D and 3D (port of
``fusion_sim_tpu/ops/sorted_deposit.py``).

Particles live sorted by grid tile, each tile's segment padded with dead
filler rows to a multiple of ``tiling.block``, so every block of
``tiling.block`` rows lies in one tile and its work touches only that
tile's window: the tile plus ``margin`` cells on every side (plus the CIC
node).  The fused substep (ops/fused_pic.py) depends on that guarantee.

The reference deposits with one-hot digit matmuls per block and folds
tile windows with dense rolls (TPU forms).  Here ``deposit_sorted_2d``
keeps the contract (same window criterion, same spill mask) and deposits
the in-window rows straight onto the grid, which is the same sum;
``gather_sorted_2d`` reads the window cells straight from the grid, and
``esirkepov_sorted_2d`` adds each row's stencil onto the wrapped grid.
``fold_tile_windows``/``extract_tile_windows`` keep their dense-roll form.
The 3D functions (``Tiling3D``, ``tile_ids_3d``, ``deposit_sorted_3d``,
``gather_sorted_3d``, ``esirkepov_sorted_3d``) keep the same contracts;
the reference's flattened-lane windows, one-hot placement matmuls and
scanned block groups are TPU forms and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.profiling import count
from .esirkepov import (esirkepov_deposit_2d, esirkepov_deposit_3d,
                        stencil_base)
from .interp import cic_deposit_packed


@dataclasses.dataclass(frozen=True)
class Tiling2D:
    """Static tile geometry: tile_r x tile_z cells, P particles per block,
    margin cells of drift tolerance on every side."""

    tile_r: int = 32
    tile_z: int = 32
    block: int = 1024
    margin: int = 4
    # the reference's one-hot matmul element type; the port computes in
    # f32 whatever it says (ops/precision.py)
    dtype: str = "float32"

    def __post_init__(self):
        # the window [-margin, tile + margin + 1) must stay within
        # [-tile, 2*tile): windows overhang at most one neighbour per side
        if self.margin + 1 > min(self.tile_r, self.tile_z):
            raise ValueError(
                f"margin {self.margin} needs margin + 1 <= tile "
                f"({self.tile_r}, {self.tile_z}) — windows may overhang at "
                f"most one neighboring tile per side")

    def n_tiles(self, shape: tuple[int, int]) -> tuple[int, int]:
        nr, nz = shape
        if nr % self.tile_r or nz % self.tile_z:
            raise ValueError(f"grid {shape} not divisible by tile "
                             f"({self.tile_r}, {self.tile_z})")
        return nr // self.tile_r, nz // self.tile_z

    def window(self) -> tuple[int, int]:
        """(wr, wz): cells of a tile window, margins and CIC node included."""
        return (self.tile_r + 2 * self.margin + 1,
                self.tile_z + 2 * self.margin + 1)


def tile_ids(position: torch.Tensor, shape: tuple[int, int],
             tiling: Tiling2D) -> torch.Tensor:
    """Flat tile id per particle (periodic grid units), int64."""
    ntr, ntz = tiling.n_tiles(shape)
    base = torch.floor(position).to(torch.int64)
    tr = torch.clamp(torch.div(base[:, 0], tiling.tile_r,
                               rounding_mode="floor"), 0, ntr - 1)
    tz = torch.clamp(torch.div(base[:, 1], tiling.tile_z,
                               rounding_mode="floor"), 0, ntz - 1)
    return tr * ntz + tz


@dataclasses.dataclass(frozen=True)
class Tiling3D:
    """3D tile geometry (see Tiling2D): tile cells per axis, P particles
    per block, margin cells of drift tolerance on every side."""

    tile: tuple[int, int, int] = (8, 8, 8)
    block: int = 512
    margin: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if self.margin + 1 > min(self.tile):  # see Tiling2D.__post_init__
            raise ValueError(
                f"margin {self.margin} needs margin + 1 <= tile "
                f"{self.tile} — windows may overhang at most one "
                f"neighboring tile per side")

    def n_tiles(self, shape: tuple[int, int, int]) -> tuple[int, int, int]:
        if any(n % t for n, t in zip(shape, self.tile)):
            raise ValueError(f"grid {shape} not divisible by tile "
                             f"{self.tile}")
        return tuple(n // t for n, t in zip(shape, self.tile))

    def window(self) -> tuple[int, int, int]:
        """(wx, wy, wz): cells of a tile window, margins and CIC node
        included."""
        return tuple(t + 2 * self.margin + 1 for t in self.tile)


def sort_by_tile(position: torch.Tensor, shape: tuple[int, int],
                 tiling: Tiling2D, *payloads: torch.Tensor):
    """Sort particles (and payloads, 1D or with a leading axis N) by tile
    id; returns ``(tile_sorted, position_sorted, *payloads_sorted)``.  A
    stable sort: the reference's ``lax.sort`` promises no order inside a
    tile, so the two agree on each tile's segment as a set of rows."""
    tid = tile_ids(position, shape, tiling)
    tid_s, order = torch.sort(tid, stable=True)
    return (tid_s, position[order], *[p[order] for p in payloads])


def tile_ids_3d(position: torch.Tensor, shape: tuple[int, int, int],
                tiling: Tiling3D) -> torch.Tensor:
    """Flat tile id per particle (z fastest), int64."""
    nts = tiling.n_tiles(shape)
    base = torch.floor(position).to(torch.int64)
    tid = 0
    for a in range(3):
        t = torch.clamp(torch.div(base[:, a], tiling.tile[a],
                                  rounding_mode="floor"), 0, nts[a] - 1)
        tid = tid * nts[a] + t
    return tid


def tile_cell_keys(position: torch.Tensor, shape: tuple[int, ...],
                   tiling) -> torch.Tensor:
    """``tile * cells + cell`` per particle, int32: its flat tile id (as
    ``tile_ids``/``tile_ids_3d`` give it, the base cell clamped into the
    grid) times the cells of a tile, plus the flat index of its base cell
    inside the tile (last axis fastest)."""
    tile = ((tiling.tile_r, tiling.tile_z) if len(shape) == 2
            else tuple(tiling.tile))
    nts = tiling.n_tiles(shape)
    dev = position.device

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    base = torch.minimum(torch.floor(position).to(torch.int32).clamp_(min=0),
                         ints([n - 1 for n in shape]))
    t = torch.div(base, ints(tile), rounding_mode="floor")
    # with ts_a, cs_a the strides of the flat tile index and of the flat
    # cell index inside a tile, and the cell base_a - t_a tile_a:
    # tile * cells + cell = sum_a t_a (cells ts_a - tile_a cs_a) + base_a cs_a
    # (the resort forms it for 30 M rows: few elementwise passes)
    cells = math.prod(tile)
    cs = [math.prod(tile[a + 1:]) for a in range(len(shape))]
    coef = [cells * math.prod(nts[a + 1:]) - tile[a] * cs[a]
            for a in range(len(shape))]
    return (t * ints(coef) + base * ints(cs)).sum(-1, dtype=torch.int32)


def tile_pads(counts: torch.Tensor, block: int, total_pad: int,
              reserve: bool = False, spread: bool = False) -> torch.Tensor:
    """Filler rows per tile (int64 (n_tiles,)) for tiles of ``counts``
    real rows: each tile's count padded to a multiple of ``block``, then
    ``reserve`` and ``spread`` as ``build_padded_layout`` describes them;
    ``total_pad`` (``n_tiles * block``) is the budget ``spread`` shares."""
    n_tiles = counts.shape[0]
    pads = torch.remainder(-counts, block)
    if reserve:
        # at most one block a tile: the n_tiles*block budget covers it
        pads = torch.where(pads == 0, block, pads)
    if spread:
        extra_blocks = torch.div(total_pad - pads.sum(), block,
                                 rounding_mode="floor")
        rank = torch.argsort(torch.argsort(pads, stable=True), stable=True)
        pads = pads + (torch.div(extra_blocks, n_tiles, rounding_mode="floor")
                       + (rank < torch.remainder(extra_blocks, n_tiles))
                       ) * block
    return pads


def build_padded_layout(position: torch.Tensor, shape: tuple[int, ...],
                        tiling, *payloads: torch.Tensor,
                        valid: torch.Tensor | None = None,
                        reserve: bool = False,
                        spread: bool = False,
                        derive_valid: bool = False,
                        cell_order: bool = False):
    """Sort particles by tile AND pad every tile's segment to a multiple of
    ``tiling.block`` with dead filler rows (position 0, payload 0).

    ``valid`` (optional, (N,) bool): invalid rows sort into the trailing
    dead region with ``tile_id = n_tiles``.  Returns ``(tile_id, position,
    *payloads, n_valid)`` of fixed length ``N + n_tiles*block``; with
    ``derive_valid`` the post-sort validity mask comes before ``n_valid``.
    ``tile_id`` is int32, like the reference's.  A payload is (N,) or
    (N, ...) and comes back with its trailing shape.

    ``reserve``: every tile keeps at least one filler row (a tile whose
    count would pad to zero gets a whole block of fillers), so that the
    repair paths (ops/repair.py) always find a dead slot in any tile.
    ``spread``: the surplus dead blocks, which would otherwise form the
    trailing region, go round-robin to the tile segments (the remainder
    to the tiles with the smallest pads), maximizing the per-tile repair
    inventory.  Neither changes the layout's length.

    ``cell_order``: the real rows of each tile follow in the order of their
    cell inside the tile (``tile_cell_keys``), so that the rows of one cell
    are neighbours; the fused kernels then sum a warp's rows of one cell
    before they add them to the window.  Nothing else changes.

    The order is that of a stable sort of the (tile[, cell], realness) key
    over the rows and then the filler slots: inside a tile the real rows in
    row order, then the fillers; the trailing region holds the invalid rows
    in row order, then the surplus fillers.  The reference's sort promises
    no order inside a tile, so the two agree on ``tile_id``/``valid`` and on
    each tile segment as a set of rows.  CUDA tensors go through the bucket
    resort of ``ops/tile_bucket.py`` (a hand-written kernel; by cell with
    its cell pass after it; the same rows bit for bit); CPU tensors take
    ``build_padded_layout_plain``.
    """
    if position.device.type == "cuda":
        from . import tile_bucket

        return tile_bucket.padded_layout(position, shape, tiling, payloads,
                                         valid, reserve, spread,
                                         derive_valid, cell_order)
    return build_padded_layout_plain(
        position, shape, tiling, *payloads, valid=valid, reserve=reserve,
        spread=spread, derive_valid=derive_valid, cell_order=cell_order)


def build_padded_layout_plain(position: torch.Tensor,
                              shape: tuple[int, ...], tiling,
                              *payloads: torch.Tensor,
                              valid: torch.Tensor | None = None,
                              reserve: bool = False, spread: bool = False,
                              derive_valid: bool = False,
                              cell_order: bool = False):
    """``build_padded_layout`` in plain PyTorch on any device: a stable
    ``torch.sort`` of the int32 (or int64) key, then one gather and one
    zeroing ``where`` a column.  Each layout built here adds 1 to the
    ``layouts_sorted`` counter of ``utils/profiling`` while a profiler
    records (the bucket kernel's counters are ``layouts_bucketed`` and
    ``layouts_by_cell``)."""
    n_tiles = math.prod(tiling.n_tiles(shape))
    p_blk = tiling.block
    n = position.shape[0]
    if n % p_blk:
        raise ValueError(f"N={n} must be a multiple of block={p_blk} "
                         "(append dead rows first)")
    dev = position.device
    total_pad = n_tiles * p_blk

    if cell_order:
        cells = (tiling.tile_r * tiling.tile_z if len(shape) == 2
                 else math.prod(tiling.tile))
        row_key = tile_cell_keys(position, shape, tiling)
        tid = torch.div(row_key, cells, rounding_mode="floor")
    else:
        cells = 1
        tid = row_key = (tile_ids if len(shape) == 2 else tile_ids_3d)(
            position, shape, tiling)
    if valid is not None:
        tid = torch.where(valid, tid, n_tiles)
        row_key = torch.where(valid, row_key, n_tiles * cells)
    counts = torch.bincount(tid, minlength=n_tiles + 1)[:n_tiles]
    pads = tile_pads(counts, p_blk, total_pad, reserve, spread)
    cum_pads = torch.cumsum(pads, 0)
    # filler j gets the tile whose cumulative pad range contains j; the
    # surplus beyond cum_pads[-1] sorts to the global end (tile = n_tiles)
    j = torch.arange(total_pad, device=dev)
    filler_tile = torch.searchsorted(cum_pads, j, right=True)
    filler_tile = torch.where(j < cum_pads[-1], filler_tile, n_tiles)

    # fillers after the real rows of their tile: key = 2*(tile*cells +
    # cell) + is_filler (cells = 1 without cell_order), where a filler
    # takes its tile's last cell
    keys = torch.cat([row_key * 2,
                      (filler_tile * cells + cells - 1) * 2 + 1])
    if 2 * (n_tiles + 1) * cells < 2 ** 31:
        keys = keys.to(torch.int32)    # half the radix passes of int64
    keys_s, order = torch.sort(keys, stable=True)
    real = order < n
    src = torch.where(real, order, 0)

    def take(col):
        return torch.where(real.reshape((-1,) + (1,) * (col.dim() - 1)),
                           col[src], torch.zeros((), dtype=col.dtype,
                                                 device=dev))

    out = [torch.div(keys_s, 2 * cells, rounding_mode="floor").to(
        torch.int32), take(position)]
    out += [take(p) for p in payloads]
    n_eff = n if valid is None else valid.sum()
    n_valid = n_eff + cum_pads[-1]
    if derive_valid:
        # real rows carry even keys; invalid real rows were re-keyed to the
        # trailing tile (key = 2*n_tiles*cells); fillers carry odd keys
        out.append((keys_s % 2 == 0) & (keys_s < 2 * n_tiles * cells))
    count("layouts_sorted", 1)
    return (*out, n_valid)


def window_origins(tile_id: torch.Tensor, shape: tuple[int, int],
                   tiling: Tiling2D) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block window origins (tile_r*i - margin, tile_z*j - margin) of
    the padded layout, int64 (nb,); the sentinel tile maps past the end."""
    _, ntz = tiling.n_tiles(shape)
    blk_tile = tile_id[::tiling.block].to(torch.int64)
    otr = torch.div(blk_tile, ntz, rounding_mode="floor") * tiling.tile_r
    otz = torch.remainder(blk_tile, ntz) * tiling.tile_z
    return otr - tiling.margin, otz - tiling.margin


def window_origins_3d(tile_id: torch.Tensor, shape: tuple[int, int, int],
                      tiling: Tiling3D) -> list[torch.Tensor]:
    """Per-block window origins (tile_a * t_a - margin per axis) of the
    padded 3D layout, three int64 (nb,) tensors; the tile index unrolls z
    fastest, and the sentinel tile maps past the end on x."""
    nts = tiling.n_tiles(shape)
    rem = tile_id[::tiling.block].to(torch.int64)
    origins = [None, None, None]
    for a in (2, 1):
        origins[a] = torch.remainder(rem, nts[a]) * tiling.tile[a] \
            - tiling.margin
        rem = torch.div(rem, nts[a], rounding_mode="floor")
    origins[0] = rem * tiling.tile[0] - tiling.margin
    return origins


def deposit_sorted_2d(position: torch.Tensor, weights: torch.Tensor,
                      tile_id: torch.Tensor, shape: tuple[int, int],
                      tiling: Tiling2D
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CIC deposit of tile-sorted particles; returns ``(grid, spill_count,
    spill_mask)``.

    Rows whose base cell lies outside their block's window (drifted past
    ``margin`` since the sort) deposit nothing and, if they carry weight,
    count as spill — the reference's contract."""
    nr, nz = shape
    wr, wz = tiling.window()
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    base = torch.floor(position).to(torch.int64)
    otr, otz = window_origins(tile_id, shape, tiling)
    dr = torch.remainder(base[:, 0] - otr.repeat_interleave(tiling.block), nr)
    dz = torch.remainder(base[:, 1] - otz.repeat_interleave(tiling.block), nz)
    in_win = (dr < wr - 1) & (dz < wz - 1)
    grid = cic_deposit_packed(position, torch.where(in_win, weights, 0.0),
                              shape)
    spill_mask = (~in_win) & (weights != 0)
    return grid, spill_mask.sum(), spill_mask


def gather_sorted_2d(grid: torch.Tensor, position: torch.Tensor,
                     tile_id: torch.Tensor, shape: tuple[int, int],
                     tiling: Tiling2D, mode: str = "cic"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile-window gather for tile-sorted particles; returns ``(values
    (N[, C]), in_win (N,) bool)``.

    ``grid`` (nr, nz[, C]); ``position`` (N, 2) grid units in the padded
    sorted layout.  A row is in its window when its base cell floor(x)
    lies within the block's window; every row reads its block's window
    at the base cell clipped into the window, so out-of-window rows get
    clamped-window values (callers patch them exactly).  ``mode='cic'``:
    linear weights (1 - frac, frac) at the clipped cell and the next, with
    frac = x - floor(x), summed z first and then r (the reference's einsum
    order); ``mode='nearest'``: the value at the clipped cell.  The
    reference's one-hot window matmuls select the same window cells."""
    if mode not in ("cic", "nearest"):
        raise ValueError(f"mode {mode!r} (cic|nearest)")
    nr, nz = shape
    wr, wz = tiling.window()
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    channels = tuple(grid.shape[2:])
    flat = grid.reshape(nr * nz, -1)
    base_f = torch.floor(position)
    frac = position - base_f
    base = base_f.to(torch.int64)
    otr, otz = (o.repeat_interleave(tiling.block)
                for o in window_origins(tile_id, shape, tiling))
    dr = torch.remainder(base[:, 0] - otr, nr)
    dz = torch.remainder(base[:, 1] - otz, nz)
    in_win = (dr < wr - 1) & (dz < wz - 1)
    gi = torch.remainder(otr + torch.clamp(dr, 0, wr - 2), nr)
    gj = torch.remainder(otz + torch.clamp(dz, 0, wz - 2), nz)
    if mode == "nearest":
        out = flat[gi * nz + gj]
    else:
        gi1, gj1 = torch.remainder(gi + 1, nr), torch.remainder(gj + 1, nz)
        fr, fz = frac[:, 0:1], frac[:, 1:2]
        ar0, ar1, az0, az1 = 1.0 - fr, fr, 1.0 - fz, fz
        out = (ar0 * (az0 * flat[gi * nz + gj] + az1 * flat[gi * nz + gj1])
               + ar1 * (az0 * flat[gi1 * nz + gj]
                        + az1 * flat[gi1 * nz + gj1]))
    return out.reshape(n, *channels), in_win


def esirkepov_sorted_2d(x0: torch.Tensor, x1: torch.Tensor,
                        vz: torch.Tensor, charge, tile_id: torch.Tensor,
                        dt: float, shape: tuple[int, int],
                        cell_size: tuple[float, float], tiling: Tiling2D
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Charge-conserving current deposition for tile-sorted particles;
    returns ``(j_grid (nr, nz, 3), spill_count, spill_mask)``.

    ``x1`` is unwrapped (x0 plus the drift).  A row is in its window when
    its wrapped stencil base, floor(min(x0, x1)) per axis, lies at most
    ``w - 3`` cells from the block's window origin on both axes; other rows
    deposit nothing and, if they carry charge, count as spill.  ``charge``
    must be 0 on filler rows.  The reference contracts separable factors
    per block with one-hot window matmuls and folds the windows; the
    in-window rows' ``esirkepov_deposit_2d`` on the wrapped grid is the
    same sum."""
    nr, nz = shape
    wr, wz = tiling.window()
    n = x0.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    q = torch.as_tensor(charge, dtype=torch.float32,
                        device=x0.device).expand(n)
    otr, otz = (o.repeat_interleave(tiling.block)
                for o in window_origins(tile_id, shape, tiling))
    dbr = torch.remainder(stencil_base(x0[:, 0], x1[:, 0]) - otr, nr)
    dbz = torch.remainder(stencil_base(x0[:, 1], x1[:, 1]) - otz, nz)
    in_win = (dbr <= wr - 3) & (dbz <= wz - 3)
    j = esirkepov_deposit_2d(x0, x1, vz, torch.where(in_win, q, 0.0), dt,
                             shape, cell_size)
    spill_mask = (~in_win) & (q != 0)
    return j, spill_mask.sum(), spill_mask


def _window_offsets_3d(base: torch.Tensor, tile_id: torch.Tensor,
                       shape: tuple[int, int, int], tiling: Tiling3D):
    """Per axis: the block window's origin per row and the offset
    mod(base - origin, n) of the int64 cells ``base`` (N, 3) from it."""
    origins = [o.repeat_interleave(tiling.block)
               for o in window_origins_3d(tile_id, shape, tiling)]
    return origins, [torch.remainder(base[:, a] - origins[a], shape[a])
                     for a in range(3)]


def deposit_sorted_3d(position: torch.Tensor, weights: torch.Tensor,
                      tile_id: torch.Tensor, shape: tuple[int, int, int],
                      tiling: Tiling3D
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3D CIC deposit of tile-sorted particles (see ``deposit_sorted_2d``);
    returns ``(grid, spill_count, spill_mask)``."""
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    wins = tiling.window()
    _, d = _window_offsets_3d(torch.floor(position).to(torch.int64), tile_id,
                              shape, tiling)
    in_win = (d[0] < wins[0] - 1) & (d[1] < wins[1] - 1) \
        & (d[2] < wins[2] - 1)
    grid = cic_deposit_packed(position, torch.where(in_win, weights, 0.0),
                              shape)
    spill_mask = (~in_win) & (weights != 0)
    return grid, spill_mask.sum(), spill_mask


def gather_sorted_3d(grid: torch.Tensor, position: torch.Tensor,
                     tile_id: torch.Tensor, shape: tuple[int, int, int],
                     tiling: Tiling3D, mode: str = "cic"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """3D tile-window gather (see ``gather_sorted_2d``); returns ``(values
    (N[, C]), in_win (N,) bool)``.

    ``grid`` (nx, ny, nz[, C]); ``position`` (N, 3) grid units in the
    padded sorted layout.  A row is in its window when its base cell lies
    within the block's window on all three axes; every row reads at the
    base cell clipped into the window, weights (1 - frac, frac) per axis
    with frac = x - floor(x), summed over z, then y, then x (the
    reference contracts the (y, z) pair first)."""
    if mode not in ("cic", "nearest"):
        raise ValueError(f"mode {mode!r} (cic|nearest)")
    n = position.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    wins = tiling.window()
    channels = tuple(grid.shape[3:])
    flat = grid.reshape(math.prod(shape), -1)
    base_f = torch.floor(position)
    frac = position - base_f
    origins, d = _window_offsets_3d(base_f.to(torch.int64), tile_id, shape,
                                    tiling)
    in_win = (d[0] < wins[0] - 1) & (d[1] < wins[1] - 1) \
        & (d[2] < wins[2] - 1)
    # wrapped grid index of the clipped cell and of the next one, per axis
    g0 = [torch.remainder(origins[a] + torch.clamp(d[a], max=wins[a] - 2),
                          shape[a]) for a in range(3)]
    ny, nz = shape[1], shape[2]
    if mode == "nearest":
        out = flat[(g0[0] * ny + g0[1]) * nz + g0[2]]
        return out.reshape(n, *channels), in_win
    g1 = [torch.remainder(g0[a] + 1, shape[a]) for a in range(3)]
    w0 = [(1.0 - frac[:, a])[:, None] for a in range(3)]
    w1 = [frac[:, a:a + 1] for a in range(3)]
    out = 0.0
    for gx, wx in ((g0[0], w0[0]), (g1[0], w1[0])):
        plane = 0.0
        for gy, wy in ((g0[1], w0[1]), (g1[1], w1[1])):
            row = (gx * ny + gy) * nz
            plane = plane + (wy * w0[2]) * flat[row + g0[2]] \
                + (wy * w1[2]) * flat[row + g1[2]]
        out = out + wx * plane
    return out.reshape(n, *channels), in_win


def esirkepov_sorted_3d(x0: torch.Tensor, x1: torch.Tensor, charge,
                        tile_id: torch.Tensor, dt: float,
                        shape: tuple[int, int, int],
                        cell_size: tuple[float, float, float],
                        tiling: Tiling3D
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3D charge-conserving current deposition for tile-sorted particles;
    returns ``(j_grid (nx, ny, nz, 3), spill_count, spill_mask)``.

    The window criterion of ``esirkepov_sorted_2d`` on three axes: the
    wrapped stencil base floor(min(x0, x1)) at most ``w - 3`` cells from the
    block's window origin.  Other rows deposit nothing and, if they carry
    charge, count as spill.  ``charge`` must be 0 on filler rows.  The
    in-window rows' ``esirkepov_deposit_3d`` on the wrapped grid is the sum
    the reference assembles per block and folds."""
    n = x0.shape[0]
    if n % tiling.block:
        raise ValueError(f"N={n} not a multiple of block={tiling.block}")
    wins = tiling.window()
    q = torch.as_tensor(charge, dtype=torch.float32,
                        device=x0.device).expand(n)
    _, d = _window_offsets_3d(stencil_base(x0, x1), tile_id, shape, tiling)
    in_win = (d[0] <= wins[0] - 3) & (d[1] <= wins[1] - 3) \
        & (d[2] <= wins[2] - 3)
    j = esirkepov_deposit_3d(x0, x1, torch.where(in_win, q, 0.0), dt, shape,
                             cell_size)
    spill_mask = (~in_win) & (q != 0)
    return j, spill_mask.sum(), spill_mask


def fold_tile_windows(tw: torch.Tensor, shape: tuple[int, int],
                      tiling: Tiling2D, wr: int, wz: int) -> torch.Tensor:
    """Fold per-TILE windows (ntr*ntz, wr, wz[, C]), anchored at
    (tile_r*i - margin, tile_z*j - margin), onto the periodic grid."""
    nr, nz = shape
    ntr, ntz = tiling.n_tiles(shape)
    tr_t, tz_t, m = tiling.tile_r, tiling.tile_z, tiling.margin
    channels = tuple(tw.shape[3:])
    tw = tw.reshape(ntr, ntz, wr, wz, *channels)
    full = torch.zeros((ntr, ntz, 3 * tr_t, 3 * tz_t, *channels),
                       dtype=torch.float32, device=tw.device)
    full[:, :, tr_t - m:tr_t - m + wr, tz_t - m:tz_t - m + wz] = tw
    g = torch.zeros((nr, nz, *channels), dtype=torch.float32,
                    device=tw.device)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(channels)))
    for si in range(3):
        for sj in range(3):
            part = full[:, :, si * tr_t:(si + 1) * tr_t,
                        sj * tz_t:(sj + 1) * tz_t]
            part = torch.roll(part, (si - 1, sj - 1), (0, 1))
            g = g + part.permute(perm).reshape(nr, nz, *channels)
    return g


def extract_tile_windows(grid: torch.Tensor, shape: tuple[int, int],
                         tiling: Tiling2D, wr: int, wz: int) -> torch.Tensor:
    """Per-tile periodic windows of ``grid`` (nr, nz[, C]) — returns
    (ntr, ntz, wr, wz[, C]) with window [i, j] anchored at
    (i*tile_r - margin, j*tile_z - margin), wrapping periodically."""
    ntr, ntz = tiling.n_tiles(shape)
    tr_t, tz_t, m = tiling.tile_r, tiling.tile_z, tiling.margin
    channels = tuple(grid.shape[2:])
    g = grid.reshape(ntr, tr_t, ntz, tz_t, *channels).movedim(2, 1)
    rows = torch.cat([
        torch.roll(g, 1, 0)[:, :, tr_t - m:],
        g,
        torch.roll(g, -1, 0)[:, :, :wr - tr_t - m],
    ], dim=2)
    return torch.cat([
        torch.roll(rows, 1, 1)[:, :, :, tz_t - m:],
        rows,
        torch.roll(rows, -1, 1)[:, :, :, :wz - tz_t - m],
    ], dim=3)
