"""Stable bucket resort of the tile-sorted layout on the card.

``padded_layout`` returns what ``build_padded_layout`` returns, row for row
and bit for bit, through the hand-written kernel ``csrc/tile_bucket.cu``.
Rows by tile (``cell_order=False``) take three launches: a count of each
chunk's rows per tile key, a scatter of every row whole to its place, a fill
of the filler rows.  Between them the wrapper scans the (key, chunk) count
matrix with ``cumsum_`` and works out each tile's pads (``tile_pads``: the
same ``reserve`` / ``spread`` arithmetic as the plain version) and segment
start on arrays of ``n_tiles + 1``; nothing is read back to the host.
Rows by cell (``cell_order=True``) add a fourth, the cell pass: the scatter
writes the rows' words into a scratch set, and the pass moves each tile's
real rows from there to the outputs in the order of their cell inside the
tile, stably (``order_cells_plain`` is its plain version).
``build_padded_layout`` calls it for CUDA tensors; the plain version,
``build_padded_layout_plain``, is the stable ``torch.sort``.

``LAUNCHES`` counts the kernel's launches (three a layout by tile, four by
cell); each layout by tile built here adds 1 to the ``layouts_bucketed``
counter of ``utils/profiling`` while a profiler records, each layout by
cell 1 to ``layouts_by_cell``.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch

from ..utils.profiling import count

LAUNCHES = 0  # launches of the four tile_bucket kernels (CUDA only)
# at most this many chunks, and at most one a 2 (n_tiles + 1) rows, so the
# int32 count matrix stays under 2 B a row
MAX_CHUNKS = 4096


def _library():
    from . import _build

    lib = _build.load("tile_bucket")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lp = ctypes.POINTER(ll)
        ip = ctypes.POINTER(i)
        lib.tile_bucket_count.argtypes = ([i, lp, lp, lp, lp, p, i, ip, p]
                                          + [ll, ll, i, p])
        lib.tile_bucket_scatter.argtypes = ([i, lp, lp, lp, lp, p, i, ip]
                                            + [p] * 4 + [ll, ll, i, p])
        lib.tile_bucket_fill.argtypes = [i, lp, lp, p, p, i, ll, p, p, p]
        lib.tile_bucket_cells.argtypes = [i, lp, lp, lp, i, ip, p, p, ll, ll,
                                          i, p]
        for fn in (lib.tile_bucket_count, lib.tile_bucket_scatter,
                   lib.tile_bucket_fill, lib.tile_bucket_cells):
            fn.restype = i
        lib.tile_bucket_error_string.argtypes = [i]
        lib.tile_bucket_error_string.restype = ctypes.c_char_p
        lib.tile_bucket_max_words.argtypes = []
        lib.tile_bucket_max_words.restype = i
        lib.tile_bucket_max_cell_counts.argtypes = []
        lib.tile_bucket_max_cell_counts.restype = i
        lib._typed = True
    return lib


def chunking(n: int, n_keys: int) -> tuple[int, int]:
    """``(chunk_rows, n_chunks)``: chunks of equal rows (the last may be
    short), at most ``MAX_CHUNKS`` and at most ``n // (2 n_keys)`` of them
    (at least one)."""
    target = max(1, min(MAX_CHUNKS, n // (2 * n_keys)))
    chunk = max(1, -(-n // target))
    return chunk, max(1, -(-n // chunk))


def _rows(name, t, n):
    """``t`` with rows of contiguous elements (a column view keeps its row
    stride); its data address, row stride and row size in bytes."""
    if t.dim() == 0 or t.shape[0] != n:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"({n}, ...)")
    if not t[:1].is_contiguous():
        t = t.contiguous()
    row_bytes = t.element_size() * math.prod(t.shape[1:])
    return t, t.data_ptr(), t.stride(0) * t.element_size(), row_bytes


def _table(values):
    return (ctypes.c_longlong * len(values))(*values)


def padded_layout(position, shape, tiling, payloads, valid, reserve: bool,
                  spread: bool, derive_valid: bool, cell_order: bool = False):
    """The padded layout of ``build_padded_layout`` on the card; the
    arguments as there, ``payloads`` a sequence."""
    global LAUNCHES
    from .sorted_deposit import tile_pads

    dims = len(shape)
    nts = tiling.n_tiles(shape)
    tile = ((tiling.tile_r, tiling.tile_z) if dims == 2
            else tuple(tiling.tile))
    n_tiles = math.prod(nts)
    n_keys = n_tiles + 1
    p_blk = tiling.block
    n = position.shape[0]
    total_pad = n_tiles * p_blk
    m = n + total_pad
    dev = position.device
    if n % p_blk:
        raise ValueError(f"N={n} must be a multiple of block={p_blk} "
                         "(append dead rows first)")
    if position.dtype != torch.float32 or position.dim() != 2 \
            or position.shape[1] < dims:
        raise TypeError(f"position must be float32 (N, >= {dims}), got "
                        f"{position.dtype} {tuple(position.shape)}")
    if m >= 2 ** 31:
        raise ValueError(f"the kernel counts rows with 32-bit ints: N + "
                         f"n_tiles * block = {m}")
    if max(shape) >= 2 ** 24:
        raise ValueError(f"the kernel compares positions with the grid's "
                         f"extent in f32: {shape}")
    cols = [_rows("position", position, n)]
    cols += [_rows("payload", p, n) for p in payloads]
    if any(c[0].device != dev for c in cols) \
            or (valid is not None and valid.device != dev):
        raise ValueError("position, payloads and valid must be on one "
                         "device")
    lib = _library()
    max_cells = lib.tile_bucket_max_cell_counts() // 16
    if cell_order and math.prod(tile) > max_cells:
        raise ValueError(f"the cell pass takes at most {max_cells} cells a "
                         f"tile: {tile}")
    max_words = lib.tile_bucket_max_words()
    if any((c[1] | c[2] | c[3]) % 4 for c in cols) \
            or sum(c[3] for c in cols) > 4 * max_words:
        raise TypeError(f"the kernel moves rows of whole 4-byte words at "
                        f"4-byte aligned addresses, {max_words} words a row "
                        f"at most")
    if valid is not None:
        if valid.dtype != torch.bool or tuple(valid.shape) != (n,):
            raise TypeError(f"valid must be bool ({n},)")
        valid = valid.contiguous()
    outs = [torch.empty((m, *c[0].shape[1:]), dtype=c[0].dtype, device=dev)
            for c in cols]
    tile_id = torch.empty((m,), dtype=torch.int32, device=dev)
    valid_out = (torch.empty((m,), dtype=torch.bool, device=dev)
                 if derive_valid else None)
    src = _table([c[1] for c in cols])
    src_stride = _table([c[2] for c in cols])
    dst = _table([o.data_ptr() for o in outs])
    # by cell the scatter writes the rows' words into the scratch, one
    # buffer laid out as the outputs, and the cell pass moves them to the
    # outputs
    dst_scatter = dst
    if cell_order:
        scratch = torch.empty((sum(c[3] for c in cols) // 4 * m,),
                              dtype=torch.int32, device=dev)
        starts = itertools.accumulate([0] + [c[3] for c in cols[:-1]])
        dst_scatter = _table([scratch.data_ptr() + m * b for b in starts])
    row_bytes = _table([c[3] for c in cols])
    geom = (ctypes.c_int * 6)(*tile, *([1] * (3 - dims)), *nts,
                              *([1] * (3 - dims)))
    valid_ptr = None if valid is None else valid.data_ptr()
    valid_out_ptr = None if valid_out is None else valid_out.data_ptr()
    chunk, n_chunks = chunking(n, n_keys)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def check(err):
        if err:
            raise RuntimeError("tile_bucket launch failed: "
                               + lib.tile_bucket_error_string(err).decode())

    scan = torch.zeros((n_keys, n_chunks + 1), dtype=torch.int32, device=dev)
    check(lib.tile_bucket_count(len(cols), src, src_stride, dst, row_bytes,
                                valid_ptr, dims, geom, scan.data_ptr(), n,
                                chunk, n_chunks, stream))
    # column c: each key's rows in the chunks before c; the last: its total
    scan.cumsum_(1)
    totals = scan[:, -1].to(torch.int64)
    pads = tile_pads(totals[:n_tiles], p_blk, total_pad, reserve, spread)
    cum_pads = torch.cumsum(pads, 0)
    # the trailing key holds the invalid rows, then the surplus fillers
    bucket_pads = torch.cat([pads, total_pad - cum_pads[-1:]])
    sizes = totals + bucket_pads
    seg_start = torch.cumsum(sizes, 0) - sizes
    pad_end = torch.cumsum(bucket_pads, 0)
    fill_base = (seg_start + totals - (pad_end - bucket_pads)).to(torch.int32)
    seg_start = seg_start.to(torch.int32)
    pad_end = pad_end.to(torch.int32)
    check(lib.tile_bucket_scatter(
        len(cols), src, src_stride, dst_scatter, row_bytes, valid_ptr, dims,
        geom, scan.data_ptr(), seg_start.data_ptr(), tile_id.data_ptr(),
        valid_out_ptr, n, chunk, n_chunks, stream))
    check(lib.tile_bucket_fill(
        len(cols), dst, row_bytes, pad_end.data_ptr(), fill_base.data_ptr(),
        n_keys, total_pad, tile_id.data_ptr(), valid_out_ptr, stream))
    LAUNCHES += 3
    if cell_order:
        real = scan[:, n_chunks]    # each key's rows, untouched by scatter
        copy_ctas = min(1024, max(1, -(-n // 65536)))  # the invalid rows
        check(lib.tile_bucket_cells(
            len(cols), dst_scatter, dst, row_bytes, dims, geom,
            seg_start.data_ptr(), real.data_ptr(), real.stride(0), n,
            copy_ctas, stream))
        LAUNCHES += 1
        count("layouts_by_cell", 1)
    else:
        count("layouts_bucketed", 1)
    n_eff = n if valid is None else n - totals[n_tiles]
    out = [tile_id, *outs]
    if derive_valid:
        out.append(valid_out)
    return (*out, n_eff + cum_pads[-1])


def order_cells_plain(layout, shape, tiling, counts):
    """The cell pass in plain PyTorch: ``layout`` (``build_padded_layout``'s
    output by tile) with each tile's real rows, the first ``counts[t]`` of
    tile ``t``'s segment, put in the order of their cell inside the tile
    (``tile_cell_keys``), stably; fillers and the trailing region stay in
    place.  ``tile_id`` and ``valid`` are constant across a tile's real
    rows, so every column is taken through the same order."""
    from .sorted_deposit import tile_cell_keys

    tile_id, position = layout[0], layout[1]
    nts = tiling.n_tiles(shape)
    n_tiles = math.prod(nts)
    cells = (tiling.tile_r * tiling.tile_z if len(shape) == 2
             else math.prod(tiling.tile))
    dev = position.device
    tid = tile_id.to(torch.int64)
    start = torch.searchsorted(tid, torch.arange(n_tiles + 1, device=dev))
    real_in = torch.cat([counts.to(torch.int64),
                         torch.zeros(1, dtype=torch.int64, device=dev)])
    rank = torch.arange(tid.shape[0], device=dev) - start[tid]
    real = rank < real_in[tid]
    cell = torch.remainder(
        tile_cell_keys(position, shape, tiling).to(torch.int64), cells)
    key = tid * (cells + 1) + torch.where(real, cell, cells)
    order = torch.sort(key, stable=True)[1]
    return (*[col[order] for col in layout[:-1]], layout[-1])
