"""Microbench: the resort's sort at 10 M-row scale (counterpart of
``examples/bench_resort.py``).

The reference compares one ``lax.sort`` dragging every payload column
through the sort network against a (key, row index) sort followed by one
gather a column.  ``torch.sort`` carries no payloads, so the first form
has no counterpart here.  This times the forms the port has, on a nearly
sorted key (a sorted base with ~3% of rows re-keyed, what a cadence
resort sees):

* the key sort (int64 keys) and its permutation, then one gather a
  payload column;
* the same on int32 keys, the type the port's layout sorts when the keys
  fit (``ops/sorted_deposit.tile_cell_keys``);
* the port's own resort, ``build_padded_layout``, on the state of a built
  layout after a drift of ~0.2 cells (what a cadence resort sees), both
  ways on the same input: on the card through the bucket kernel
  (``ops/tile_bucket.py``) and through the stable sort
  (``build_padded_layout_plain``), checked row for row, by tile and by
  cell (the bucket kernel and its cell pass) (``--dim 2``: 512^2,
  ``Tiling2D(32, 32, 1024, margin 6)``, velocity (N, 2), the ES 2D
  shell's; ``--dim 3``: 128^3, ``Tiling3D((8, 8, 8), 512, margin 2)``,
  velocity (N, 3), the EM 3D shell's by tile and the ES 3D shell's by
  cell).

    python -m fusion_sim_torch.examples.bench_resort --n 12582912 \\
        --payloads 6
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import device_name, resolve_device
from ..ops.sorted_deposit import (Tiling2D, Tiling3D, build_padded_layout,
                                  build_padded_layout_plain)
from .kernel_pair import median_ms


def layout_case(n: int, dim: int, dev):
    """(shape, tiling, position, velocity, valid): a layout's state of
    ``n`` rows (random positions laid out by tile, cut to ``n`` rows), each
    row then drifted by ~0.2 cells."""
    if dim == 2:
        shape, tiling = (512, 512), Tiling2D(32, 32, 1024, margin=6)
    else:
        shape = (128, 128, 128)
        tiling = Tiling3D(tile=(8, 8, 8), block=512, margin=2)
    rng = np.random.default_rng(1)
    ext = torch.tensor(shape, dtype=torch.float32, device=dev)
    pos = torch.tensor((rng.random((n, dim)) * shape).astype(np.float32),
                       device=dev)
    vel = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32),
                       device=dev)
    _, pos, vel, valid, _ = build_padded_layout_plain(
        pos, shape, tiling, vel, derive_valid=True)
    pos, vel, valid = pos[:n], vel[:n], valid[:n]
    pos = torch.remainder(pos + 0.2 * vel, ext)
    return shape, tiling, pos, vel, valid


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=12_582_912)
    ap.add_argument("--payloads", type=int, default=6,
                    help="payload columns besides the key (ES sorted model: "
                         "pos r/z + vel r/z + weights + spare)")
    ap.add_argument("--tiles", type=int, default=256)
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3),
                    help="the layout of the build_padded_layout forms")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, npay = args.n, args.payloads
    rng = np.random.default_rng(0)
    base = np.sort(rng.integers(0, args.tiles, n).astype(np.int32))
    movers = rng.random(n) < 0.03
    keys32 = torch.tensor(np.where(movers, rng.integers(0, args.tiles, n),
                                   base).astype(np.int32), device=dev)
    keys64 = keys32.to(torch.int64)
    pays = [torch.tensor(rng.random(n, dtype=np.float32), device=dev)
            for _ in range(npay)]
    print(f"n={n:.3e} payload_cols={npay} dev={device_name(dev)}")
    print(f"one-sort ({1 + npay} operands) : no counterpart (torch.sort "
          f"carries no payloads)")

    def sort_then_take(keys):
        k2, idx = torch.sort(keys, stable=True)
        return (k2,) + tuple(p[idx] for p in pays)

    def ms(fn):
        return median_ms(fn, reps=args.reps, device=dev)

    t64 = ms(lambda: sort_then_take(keys64))
    t32 = ms(lambda: sort_then_take(keys32))
    print(f"key+index sort (int64), {npay} column takes : {t64:7.3f} ms")
    print(f"key+index sort (int32), {npay} column takes : {t32:7.3f} ms")

    shape, tiling, pos, vel, valid = layout_case(n, args.dim, dev)

    def layout(build, cell_order=False):
        return lambda: build(pos, shape, tiling, vel, valid=valid,
                             derive_valid=True, cell_order=cell_order)

    out = {"sort64_ms": t64, "sort32_ms": t32}
    for cell_order, key in ((False, "layout"), (True, "layout_by_cell")):
        got = layout(build_padded_layout, cell_order)()
        want = layout(build_padded_layout_plain, cell_order)()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        del got, want
        t_bucket = ms(layout(build_padded_layout, cell_order))
        t_sort = ms(layout(build_padded_layout_plain, cell_order))
        print(f"build_padded_layout ({args.dim}D, rows by "
              f"{'cell' if cell_order else 'tile'}, velocity "
              f"(N, {args.dim})) : bucket kernel {t_bucket:7.3f} ms"
              f"{' (on the CPU: the sort)' if dev.type == 'cpu' else ''}, "
              f"sort {t_sort:7.3f} ms, the same rows: {same}")
        out.update({f"{key}_ms": t_bucket, f"{key}_sort_ms": t_sort,
                    f"{key}_same_rows": same})
    out["same_rows"] = out.pop("layout_same_rows")
    return out

if __name__ == "__main__":
    main()
