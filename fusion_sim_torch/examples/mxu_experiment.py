"""Contraction-depth experiment on the card's tensor cores.

Port of ``examples/mxu_experiment.py``.  The TPU script asked whether the
matrix unit's pass depth follows the logical contraction depth K or the
padded lane width, by timing bare matrix products at K in {24, 32, 48, 96,
128} in both operand orders and both precisions.  Here the same products
run on kernel X1 (``ops/contraction_depth.py``): ``mma.sync`` on Hopper's
tensor cores, K padded to the instruction's depth (16 bf16, 8 TF32).

    python -m fusion_sim_torch.examples.mxu_experiment            # the card
    python -m fusion_sim_torch.examples.mxu_experiment --device cpu \\
        --nsteps 2 --n-g 2 --p 128                                # plain, CPU

Prints, like the TPU script, the device and sizes, then one line per
order, precision and K: the median time and the rows a second
(nsteps * n_g * p / t).
"""

from __future__ import annotations

import argparse
import time

import torch

from .._device import resolve_device
from ..ops.contraction_depth import ORDERS, PRECISIONS, contraction_depth

DEPTHS = (24, 32, 48, 96, 128)


def timeit(fn, *args, reps: int = 7) -> float:
    """Median seconds of ``fn(*args)``: CUDA events on the card, the host
    clock on the CPU; one warm call first."""
    out = fn(*args)
    cuda = out.device.type == "cuda"
    ts = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def make_bench(m: int, k: int, p: int, n_g: int, nsteps: int, order: str,
               precision: str, device=None):
    """``(fn, a, b)``: ``fn(a, b)`` runs the n_g products of (m, k) x (k, p)
    per step (order 'lhs_k_lanes') or the contraction over A's first axis
    ('lhs_k_sublanes'), ``nsteps`` steps; a and b are standard normal f32
    from generators seeded 0 and 1 on the device."""
    dev = resolve_device(device)
    a_shape = (m, k) if order == "lhs_k_lanes" else (k, m)
    gen = torch.Generator(device=dev)
    a = torch.randn((nsteps, n_g, *a_shape), generator=gen.manual_seed(0),
                    dtype=torch.float32, device=dev)
    b = torch.randn((nsteps, n_g, k, p), generator=gen.manual_seed(1),
                    dtype=torch.float32, device=dev)

    def fn(a, b):
        return contraction_depth(a, b, order, precision)

    return fn, a, b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=1024)
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--n-g", type=int, default=32)
    ap.add_argument("--nsteps", type=int, default=305)  # ~10M rows worth
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain version (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    total = args.nsteps * args.n_g * args.p
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"dev={name}  m={args.m} p={args.p} "
          f"blocks={args.nsteps * args.n_g} (~{total / 1e6:.1f}M rows)")
    for order in ORDERS:
        for prec in PRECISIONS:
            for k in DEPTHS:
                fn, a, b = make_bench(args.m, k, args.p, args.n_g,
                                      args.nsteps, order, prec, dev)
                t = timeit(fn, a, b)
                print(f"{order:16s} {prec:8s} K={k:3d}: "
                      f"{1e3 * t:7.2f} ms ({total / t / 1e9:.2f}G rows/s)")
                del a, b


if __name__ == "__main__":
    main()
