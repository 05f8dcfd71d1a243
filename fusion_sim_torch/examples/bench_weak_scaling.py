"""Weak scaling: steps/s against the number of ranks at a fixed number of
particles a rank (counterpart of ``examples/bench_weak_scaling.py``).

Runs the domain-decomposed models (``ShardedElectromagneticPIC`` plain and
sorted, ``ShardedElectrostaticPIC`` plain) on a ring of ranks, the
problem growing with the ring so that a rank's work stays the same:
perfect weak scaling is a flat ms/step.  Each rank is one process.

    python -m fusion_sim_torch.examples.bench_weak_scaling --devices 1 2 4 --cpu
    torchrun --nproc-per-node 4 -m fusion_sim_torch.examples.bench_weak_scaling

With ``--cpu`` every count of ``--devices`` runs in a gloo world of CPU
ranks that this script spawns (the figures are then the CPU's).  On the
card a count of 1 runs in this process; a larger count runs one process a
card under ``torchrun --nproc-per-node N``, which runs the launcher's one
count.  Each count reports ms/step and particle updates/s a rank;
``--phases`` adds the plain ES step's phases, each timed on its own.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .._device import resolve_device, synchronize
from ..models import electromagnetic as em
from ..models import electrostatic as es
from ..models.electromagnetic_sharded import (ShardedElectromagneticPIC,
                                              ShardedEMConfig)
from ..models.electrostatic_sharded import (APRON_W, HALO_W,
                                            ShardedElectrostaticPIC,
                                            ShardedESConfig)
from ..ops.interp import cic_deposit_packed, cic_gather_packed
from ..ops.solvers import poisson_fft_sharded
from ..ops.sorted_deposit import Tiling2D
from ..parallel import halo, migration
from ..parallel.mesh import make_mesh


def _fence(sim):
    synchronize(sim.device)
    dist.barrier(group=sim._ring.group)


def bench_model(sim, n_steps=10, reps=3):
    """Median seconds a step over ``reps`` runs of ``n_steps`` after one
    warm step; each run ends in a device synchronize and a barrier of the
    ring."""
    sim.step(1)
    _fence(sim)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sim.step(n_steps)
        _fence(sim)
        times.append((time.perf_counter() - t0) / n_steps)
    return sorted(times)[len(times) // 2]


def bench_fn(fn, device, n=10, reps=3, group=None):
    """Median seconds a call of ``fn`` (fenced like ``bench_model``)."""
    fn()
    synchronize(device)
    times = []
    for _ in range(reps):
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        synchronize(device)
        times.append((time.perf_counter() - t0) / n)
    return sorted(times)[len(times) // 2]


def phase_times_es(cfg, sim):
    """The plain sharded ES step's phases on this rank, each timed on its
    own on the live state's shapes: deposit, apron fold, field halo, the
    distributed FFT solve, gather, migration (the fractions are of their
    sum; the whole step overlaps none of them here)."""
    base = cfg.base
    slab, rest = cfg.slab, base.grid_shape[1:]
    pad_shape = (slab + 2 * APRON_W, *rest)
    halo_shape = (slab + 2 * HALO_W, *rest)
    st, group, dev = sim.state, sim._ring.group, sim.device
    pos, vel, alive = st.position, st.velocity, st.alive
    w = torch.where(alive, 1.0, 0.0).to(torch.float32)
    local = (slab, *rest)
    rho = torch.zeros(local, device=dev)
    rho_pad = torch.zeros(pad_shape, device=dev)
    e_local = torch.zeros((*local, base.n_dim), device=dev)

    def in_slab(p, width):
        q = p.clone()
        q[:, 0] = torch.remainder(p[:, 0], float(slab)) + width
        return q

    phases = {
        "deposit": lambda: cic_deposit_packed(in_slab(pos, APRON_W), w,
                                              pad_shape),
        "apron": lambda: halo.accumulate_apron(rho_pad, group, APRON_W),
        "halo": lambda: halo.with_halo(e_local, group, HALO_W),
        "solve": lambda: poisson_fft_sharded(rho, base.grid_shape,
                                             base.cell_size, group),
        "gather": lambda: cic_gather_packed(
            halo.with_halo(e_local, group, HALO_W), in_slab(pos, HALO_W),
            halo_shape),
    }
    if cfg.n_shards > 1:
        def mig():
            x = torch.remainder(pos[:, 0], float(slab))
            migration.migrate_ring((pos, vel), alive, alive & (x < 0.05),
                                   alive & (x > slab - 0.05), group,
                                   cfg.migration_buffer)
        phases["migrate"] = mig
    return {name: bench_fn(fn, dev, group=group)
            for name, fn in phases.items()}


def run_count(nd: int, args, device) -> list:
    """Every model at ``nd`` ranks on this rank's ring (the world's first
    ``nd`` ranks; rank 0 prints); returns the rows ``(label, nd, ms,
    updates/s a rank)``."""
    mesh = make_mesh(nd, ("space",), device=device)
    rank0 = dist.get_rank() == 0
    n = args.per_device * nd
    nx, ny = args.cells_x_per_device * nd, args.cells_y
    d = 0.5
    rng = np.random.default_rng(0)
    pos = (rng.random((n, 2)) * [nx, ny]).astype(np.float32)
    vel = (0.2 * rng.standard_normal((n, 3))).astype(np.float32)
    cap = int(args.per_device * 1.5) // 1024 * 1024 + 1024
    rows = []

    def report(label, t):
        rows.append((label, nd, 1e3 * t, n / t / nd))
        if rank0:
            print(f"{label:10s} nd={nd}: {1e3 * t:8.1f} ms/step  "
                  f"{n / t / nd:.3e} updates/s/device", flush=True)

    base = em.EMConfig(grid_shape=(nx, ny), cell_size=(d, d), dt=0.2 * d,
                       charge=-0.01, mass=0.01, field_gather="centered")
    for label, tiling in (("em-packed", None),
                          ("em-sorted", Tiling2D(tile_r=8, tile_z=8,
                                                 block=1024, margin=2))):
        cfg = ShardedEMConfig(base=base, n_shards=nd, capacity=cap,
                              migration_buffer=4096, tiling=tiling,
                              resort_every=6)
        sim = ShardedElectromagneticPIC(cfg, mesh, pos, vel, device=device)
        report(label, bench_model(sim, n_steps=args.steps))
        del sim

    d_es = 2 * np.pi / ny
    es_cfg = ShardedESConfig(
        base=es.ESConfig(grid_shape=(nx, ny), cell_size=(d_es, d_es),
                         dt=0.05, charge=-1.0 / n, mass=1.0 / n),
        n_shards=nd, capacity=cap, migration_buffer=4096)
    sim = ShardedElectrostaticPIC(
        es_cfg, mesh, pos,
        (0.05 * rng.standard_normal((n, 2))).astype(np.float32),
        device=device)
    report("es-fft", bench_model(sim, n_steps=args.steps))
    if args.phases:
        ph = phase_times_es(es_cfg, sim)
        tot = sum(ph.values())
        comm = sum(v for k, v in ph.items()
                   if k in ("halo", "apron", "migrate"))
        if rank0:
            print(f"  es phases nd={nd}: " + "  ".join(
                f"{k}={1e3 * v:.2f}ms({100 * v / tot:.0f}%)"
                for k, v in ph.items()))
            print(f"  es comm fraction nd={nd}: {100 * comm / tot:.1f}% "
                  f"(halo+apron+migrate; the solve's all_to_all counted "
                  f"as solve)", flush=True)
    return rows


def _spawned_rank(rank, nd, args, out_dir):
    """One rank of a spawned gloo world of ``nd`` CPU ranks."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=nd, timeout=datetime.timedelta(seconds=600))
    try:
        rows = run_count(nd, args, torch.device("cpu"))
        if rank == 0:
            with open(os.path.join(out_dir, "rows.pkl"), "wb") as f:
                pickle.dump(rows, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn_count(nd: int, args) -> list:
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_spawned_rank, args=(nd, args, out_dir), nprocs=nd,
                 join=True)
        with open(os.path.join(out_dir, "rows.pkl"), "rb") as f:
            return pickle.load(f)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--per-device", type=int, default=131072,
                    help="particles per device")
    ap.add_argument("--cells-x-per-device", type=int, default=32)
    ap.add_argument("--cells-y", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo worlds of CPU ranks (tests)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--phases", action="store_true",
                    help="per-phase timings (deposit/halo/solve/gather/"
                         "migration) for the ES model per device count")
    args = ap.parse_args(argv)

    rows = []
    if "WORLD_SIZE" in os.environ:       # one count: the launcher's ranks
        rows = run_count(int(os.environ["WORLD_SIZE"]), args,
                         resolve_device("cpu" if args.cpu else None))
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:
            return rows
    else:
        if args.cpu:
            avail, kind = os.cpu_count(), "cpu"
        else:
            resolve_device(None)
            avail = torch.cuda.device_count()
            kind = torch.cuda.get_device_name(0)
        print(f"devices available: {avail} ({kind})")
        for nd in args.devices:
            if nd > avail:
                print(f"-- skipping n_devices={nd} (> {avail} available)")
            elif args.cpu:
                rows += _spawn_count(nd, args)
            elif nd == 1:
                # one card: this process is the world of one
                rows += run_count(1, args, resolve_device(None))
                dist.destroy_process_group()
            else:
                print(f"-- n_devices={nd}: one process a card, run under "
                      f"torchrun --nproc-per-node {nd}")

    print("\nweak scaling summary (flat ms/step = perfect):")
    for label in dict.fromkeys(r[0] for r in rows):
        xs = [(r[1], r[2]) for r in rows if r[0] == label]
        base_t = xs[0][1]
        eff = ", ".join(f"nd={n}: {t:.1f}ms ({100 * base_t / t:.0f}%)"
                        for n, t in xs)
        print(f"  {label}: {eff}")
    return rows


if __name__ == "__main__":
    main()
