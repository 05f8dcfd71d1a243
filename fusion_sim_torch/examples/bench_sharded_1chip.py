"""Benchmark: the domain-decomposed models at n_shards = 1 on one card
(counterpart of ``examples/bench_sharded_1chip.py``).

Measures the cost of the whole sharded composition (the halo/apron
pseudo-grid, migration, the distributed solve) against the single-device
fused model at the same rung; the reference holds its sharded-sorted-fused
step within 1.3x of the single-device one.  This script prints the ratio
and does not fail on it.  The sharded model runs in a world of one
(``parallel.mesh.make_mesh``: NCCL on the card, gloo with ``--device
cpu``).

    python -m fusion_sim_torch.examples.bench_sharded_1chip --model em
    python -m fusion_sim_torch.examples.bench_sharded_1chip --model es --repair
    python -m fusion_sim_torch.examples.bench_sharded_1chip --mesh2d --dim 3
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch.distributed as dist

from .._device import device_name, resolve_device, synchronize
from ..models import electromagnetic as em
from ..models import electrostatic as es
from ..models.electromagnetic_sharded import (ShardedElectromagneticPIC,
                                              ShardedEMConfig)
from ..models.electromagnetic_sharded2d import (ShardedElectromagneticPIC2D,
                                                ShardedEMConfig2D)
from ..models.electrostatic_sharded import (ShardedElectrostaticPIC,
                                            ShardedESConfig)
from ..models.electrostatic_sharded2d import (ShardedElectrostaticPIC2D,
                                              ShardedESConfig2D)
from ..ops.sorted_deposit import Tiling2D, Tiling3D
from ..parallel.mesh import make_mesh


def bench(sim, label, n, steps=10, reps=3, warmup=0):
    """Median seconds a step over ``reps`` runs of ``steps`` after a warm
    run of max(steps, 7, warmup) steps, each run fenced by a device
    synchronize; prints the reference's line."""
    sim.step(max(steps, 7, warmup))
    synchronize(sim.device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sim.step(steps)
        synchronize(sim.device)
        ts.append((time.perf_counter() - t0) / steps)
    med = sorted(ts)[len(ts) // 2]
    print(f"{label}: {1e3 * med:.1f} ms/step  ({n / med:.2e} updates/s)")
    return med


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=0,
                    help="0 = per-dim default (10_002_432 in 2D; the "
                         "BASELINE config[3] 29_997_056 in 3D)")
    ap.add_argument("--cells", type=int, default=0,
                    help="0 = per-dim default (512^2 / 128^3)")
    ap.add_argument("--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--model", default="es", choices=["es", "em"])
    ap.add_argument("--precision", default="highest",
                    choices=["highest", "exact_bf16", "exact_bf16_pack",
                             "exact_bf16_pack2", "default"],
                    help="the reference's matmul strategy (the card "
                         "computes every name in f32)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--slack", type=float, default=1.05,
                    help="per-shard slot capacity as a multiple of the "
                         "initial load (dead slots run as filler blocks; at "
                         "one shard nothing migrates)")
    ap.add_argument("--repair", action="store_true",
                    help="incremental layout repair instead of resorts")
    ap.add_argument("--eager", type=int, default=0,
                    help="repair_eager: relocate this many cells before "
                         "window exit")
    ap.add_argument("--spill-capacity", type=int, default=0,
                    help="0 = auto (equilibrium-sized for repair runs)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="0 = auto (spill equilibrium for ES repair runs)")
    ap.add_argument("--mesh2d", action="store_true",
                    help="the two-axis mesh composition on a (1, 1) mesh")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions (default: the card)")
    args = ap.parse_args(argv)
    if args.mesh2d and (args.repair or args.eager):
        raise SystemExit("--mesh2d does not support repair/eager")
    return args


def _rung(args):
    """The reference's rung (examples/bench_sharded_1chip.py:84-178): the
    particles, tiling, cadences and capacity."""
    ndim = args.dim
    n = args.n or (10_002_432 if ndim == 2 else 29_997_056)
    nc = args.cells or (512 if ndim == 2 else 128)
    rng = np.random.default_rng(0)
    pos = (rng.random((n, ndim)) * nc).astype(np.float32)
    if ndim == 2:
        tiling = Tiling2D(tile_r=32, tile_z=32, block=1024, margin=6)
        resort_es, resort_em = 16, 12
    else:
        tiling = Tiling3D(tile=(8, 8, 8), block=512, margin=2)
        resort_es = resort_em = 6
    cap = (int(n * args.slack) // 1024) * 1024 + 1024
    return ndim, n, nc, rng, pos, tiling, resort_es, resort_em, cap


def build_sim(args, single: bool = False):
    """``(sim, label, warm-up steps)``: the rung's sharded model (in a
    world of one, started here where none is), or with ``single`` the
    single-device fused model at the same rung from the same particles."""
    ndim, n, nc, rng, pos, tiling, resort_es, resort_em, cap = _rung(args)
    dev = resolve_device(args.device)
    grid = (nc,) * ndim
    if args.model == "es":
        length = 2 * np.pi
        vol = length ** ndim
        base = es.ESConfig(grid_shape=grid, cell_size=(length / nc,) * ndim,
                           dt=0.05, charge=-vol / n, mass=vol / n)
        vel = (0.05 * rng.standard_normal((n, ndim))).astype(np.float32)
        # repair runs measure the spill equilibrium (~0.8%/step relocating
        # at tile 32 margin 6): the patch buffer is sized for it and the
        # run warms up to it (examples/bench_es_fused.py)
        spill_cap = args.spill_capacity or (
            163840 if args.repair else (16384 if ndim == 2 else 65536))
        warmup = args.warmup or (117 if args.repair else 0)
        eager_kw = {}
        if args.eager:
            eager_kw = dict(repair_eager=args.eager, eager_capacity=196608)
            spill_cap = args.spill_capacity or 16384
        resort = 10 ** 9 if args.repair else resort_es
        free = 2048 if args.repair else 256
        if single:
            return es.SortedElectrostaticPIC(
                base, pos, vel, tiling=tiling, resort_every=resort,
                spill_capacity=spill_cap, backend="pallas",
                repair=args.repair, repair_free_slots=free,
                pallas_precision=args.precision, check_spill=False,
                device=dev, **eager_kw), f"es-pallas {ndim}D", warmup
        if args.mesh2d:
            cfg2 = ShardedESConfig2D(
                base=base, mesh_shape=(1, 1), capacity=cap,
                migration_buffer=8192, tiling=tiling,
                resort_every=resort_es, backend="pallas",
                spill_capacity=spill_cap, pallas_precision=args.precision)
            mesh = make_mesh(1, ("sx", "sy"), shape=(1, 1), device=dev)
            return (ShardedElectrostaticPIC2D(cfg2, mesh, pos, vel,
                                              device=dev),
                    f"sharded2d-es-pallas (1,1) {ndim}D", warmup)
        cfg = ShardedESConfig(
            base=base, n_shards=1, capacity=cap, migration_buffer=8192,
            tiling=tiling, resort_every=resort, repair=args.repair,
            backend="pallas", spill_capacity=spill_cap,
            repair_free_slots=free, pallas_precision=args.precision,
            **eager_kw)
        mesh = make_mesh(1, ("space",), device=dev)
        return (ShardedElectrostaticPIC(cfg, mesh, pos, vel, device=dev),
                f"sharded-es-pallas nd=1 {ndim}D", warmup)
    d = 0.5
    base = em.EMConfig(grid_shape=grid, cell_size=(d,) * ndim, dt=0.2 * d,
                       charge=-0.01, mass=0.01, field_gather="centered")
    vel = (0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    resort = 10 ** 9 if args.repair else resort_em
    if single:
        return em.SortedElectromagneticPIC(
            base, pos, vel, tiling=tiling, resort_every=resort,
            gather_backend="fused", repair=args.repair,
            pallas_precision=args.precision, check_spill=False,
            device=dev), f"em-fused {ndim}D", 0
    if args.mesh2d:
        cfg2 = ShardedEMConfig2D(
            base=base, mesh_shape=(1, 1), capacity=cap,
            migration_buffer=8192, tiling=tiling, resort_every=resort_em,
            gather_backend="fused", pallas_precision=args.precision)
        mesh = make_mesh(1, ("sx", "sy"), shape=(1, 1), device=dev)
        return (ShardedElectromagneticPIC2D(cfg2, mesh, pos, vel,
                                            device=dev),
                f"sharded2d-em-fused (1,1) {ndim}D", 0)
    cfg = ShardedEMConfig(base=base, n_shards=1, capacity=cap,
                          migration_buffer=8192, tiling=tiling,
                          resort_every=resort, repair=args.repair,
                          gather_backend="fused",
                          pallas_precision=args.precision)
    mesh = make_mesh(1, ("space",), device=dev)
    return (ShardedElectromagneticPIC(cfg, mesh, pos, vel, device=dev),
            f"sharded-em-fused nd=1 {ndim}D", 0)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    n = args.n or (10_002_432 if args.dim == 2 else 29_997_056)
    nc = args.cells or (512 if args.dim == 2 else 128)
    print(f"n={n:.2e} cells={nc}^{args.dim} dev={device_name(dev)}")
    try:
        sim, label, warmup = build_sim(args)
        t = bench(sim, label, n, steps=args.steps, warmup=warmup)
        inv = sim.check_invariants()
        dropped = int(sim.state.spill_dropped.sum())
        del sim
        single, label_1, warmup_1 = build_sim(args, single=True)
        t_1 = bench(single, label_1, n, steps=args.steps, warmup=warmup_1)
        dropped_1 = int(single.state.spill_dropped)
        del single
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    print(f"ratio sharded / single-device: {t / t_1:.3f}x (the "
          f"reference's bar: within 1.3x); overflow {inv['overflow']}, "
          f"rows dropped past the spill capacity {dropped} (single-device "
          f"{dropped_1})")
    return {"ms": 1e3 * t, "single_ms": 1e3 * t_1, "ratio": t / t_1,
            "overflow": inv["overflow"], "dropped": dropped,
            "single_dropped": dropped_1}


if __name__ == "__main__":
    main()
