#!/usr/bin/env python3
"""Build the port's kernels and drive its main paths on one CUDA card.

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero with no result):

1. card      — name and power limit (nvidia-smi), CUDA and torch versions;
2. build     — every ``fusion_sim_torch/csrc/*.cu`` with nvcc for sm_90a,
               one nvcc per source, all started together;
3. kernels   — each kernel against its plain PyTorch version on the card:
               B1 (es2d_substep) at the ES headline tiling, thermal and
               heavy-spill inputs; B2 (pusher_substep) at the fused pusher's
               default tiling (8 x 100, margin 6) on the default scenario,
               its own and a heavy-spill input; B3 (gather2d) at the pallas
               pusher's default tiling (50 x 50, margin 4), nearest with 12
               and 1 channels and cic with 6; B4 (em2d_substep) at the EM
               tiling (32 x 32, margin 6), thermal and heavy-spill inputs,
               non-relativistic and relativistic; then small ES, pusher
               (backends fused and pallas) and EM (gather backends xla,
               pallas and fused) runs on the card against the same runs on
               the CPU; B5 (es3d_substep) and B6 (em3d_substep) at the 3D
               tiling (8^3, block 512, margin 2) on a 64^3 grid, thermal
               and heavy-spill inputs, and B5 at the slab's tiling
               ((8, 16, 16), margin 2) on the slab cut to 128 x 128 x 64
               after one window (B6 also relativistic, and both
               forms of its field read: the staged window and, at margin
               7, the corners through L1), then small 3D ES and EM runs on
               the card against the CPU across resorts; the B4, B5 and B3
               cases of tests/test_torch_kernels_cuda.py in a process of
               their own (the bucket resort against the sort on 2D and 3D
               tilings, bit for bit; B4: each of its forms by window, on
               tiles of ~20 blocks, the EM rungs' windows, rows by cell,
               windows read through L1, heavy spill, the repair layout and
               the refused window; B5: empty tiles, tiles of one block and
               of twenty, sentinel blocks, rows by tile, by cell and
               shuffled inside each tile, heavy spill, the largest windows
               and the smallest refused one; B3: 1, 3, 6, 12 and 13 channels in
               both modes and the edges of its periodic wrap; Y2 and T2 on
               512^2, odd, ragged and sub-halo grids, word and float copies,
               refusals, and one fused 2D step through them against the
               plain grid phase, bit for bit); X1
               (contraction_depth) at m = 96, p = 256, G = 4, S = 8 for
               both orders, both precisions and every K, and at the edges
               of its load ring (G 1 and 5, K 8, 40 and 136, m 20 and 36,
               p 100, 128 and 196); small runs on the
               card against the CPU of ES 2D ``backend='xla'``, ES 2D and
               3D ``repair=True, repair_eager=1``, EM 2D fused with repair,
               EM 3D fused with repair and eager 1, the fused pusher with
               repair, and the analytic fast path on the same uniforms;
               ``spindle_cusp_field`` (n_power 2, 100 x 200) and
               ``weighted_jacobi`` (1024 x 1024) on the card against the
               CPU;
Phases 4-11 build their sims through the port's bench and example builders
(``fusion_sim_torch.bench``, ``examples.bench_em_fused``,
``examples.bench_3d``), the configurations users run.

4. ES main path — ``SortedElectrostaticPIC(backend='pallas')`` at the
               headline size (9,999,360 particles, 512^2, tile 32, margin
               10, resort every 20): one warm window, two timed windows;
               launch counts, drops, finiteness and charge are checked, B1
               is timed against its plain version and its bound on the
               path's own inputs, and one profiled window shows the device
               time by kernel and the device busy share;
5. pusher    — ``CylindricalParticlePusher`` on the default scenario at
               16,810,000 protons, 400 x 800, ``enable_sorted_path(
               backend='fused', resort_every=10, spill_capacity=16384)``:
               one warm window, three timed windows, drops, validity,
               finiteness, B2 launches and a density frame checked, B2
               timed on the path's own inputs, one profiled window;
5b. pallas   — the same scenario at 1,048,576 protons with
               ``backend='pallas'`` (resort 12, respawn 512, spill 32768):
               B3 launches by form (2 + 2 a step: nearest C = 12 and the
               C = 1 sink) and drops checked, each form held bit for bit
               against its plain version and timed on the path's inputs,
               one profiled window;
6. EM main path — ``SortedElectromagneticPIC(gather_backend='fused')`` at
               the EM rung's size (10,002,432 particles, 512^2, cell 0.5,
               dt 0.1, tile 32, margin 6, resort every 12, spill capacity
               16384; the shell orders each tile's rows by cell): one warm
               window, two timed windows; B4, Y2 and T2 launches (one a
               step each), drops, validity, finiteness and Gauss's law
               checked, B4 timed against its plain version and its bound on
               the path's own inputs, T2 (the 2D node table) and Y2 (the 2D
               Yee update) held bit for bit against their plain versions on
               the path's live fields (all zero fails) and timed beside
               them and their byte bounds, one profiled window;
6b. EM pallas — the same configuration at 1,048,576 particles with
               ``gather_backend='pallas'``: B3 launches (cic, 6 channels)
               and drops checked, steps/s printed, B3 held bit for bit
               against its plain version and timed against its bound on the
               route's own inputs, one profiled window;
7. 3D ES main path — ``SortedElectrostaticPIC(backend='pallas')`` with a
               3D config at the 3D rung's size (29,997,056 particles,
               128^3, L = 2 pi, dt 0.05, ``Tiling3D((8, 8, 8), 512,
               margin=2)``, resort every 6; the shell orders each tile's
               rows by cell): one warm window, three timed windows; B5
               launches, drops, validity, finiteness, charge and the cell
               order after the resort checked, B5 timed against its plain
               version and its bound on the path's own inputs, the resort
               timed by cell and by tile, one profiled window;
8. 3D EM main path — ``SortedElectromagneticPIC(gather_backend='fused')``
               with a 3D config at the same size (cell 0.5, dt 0.1, charge
               -0.01, mass 0.01, centered gather, the same tiling, resort
               every 6): one warm window, three timed windows; B6, Y1 and
               T1 launches (one a step each), the bucket resort's (3 a
               resort; also in phase 4), drops, validity, finiteness and
               Gauss's law checked, B6 timed against its plain version and
               its bound on the path's own inputs, T1 (the node table) and
               Y1 (the Yee update) held bit for bit against their plain
               versions on the path's fields and timed beside them and
               their byte bounds, one profiled window;
8b. resort   — the bucket resort (``csrc/tile_bucket.cu``) on the state of
               each resort cell of ``port_bench`` after a window (ES 2D
               9,999,360 particles on 512^2, tile 32, block 1024; EM 3D
               29,997,056 and 419,958,784 on 128^3, tile 8^3, block 512;
               the state laid out by tile and drifted as a window drifts
               it), and rows by cell, the bucket resort and its cell pass,
               on the ES 3D cell's (29,997,056, 128^3, tile 8^3) and the
               2D3V cell's (10,002,432, 512^2, tile 32, velocity (N, 3))
               states laid out by cell: held bit for bit against the sort
               (``build_padded_layout_plain``), then both timed beside the
               resort's byte bound (a row read and written once) and the
               design's floor (the count reads it once more; by cell, the
               pass reads the position a third time and moves each row's
               words once more), the cell pass alone from a profiler;
               the launches reported are the main path's (phases 4, 8);
9. X1        — the contraction-depth experiment's default sweep at full
               size (S = 305, G = 32, m = 96, p = 1024; both orders, both
               precisions, K in {24, 32, 48, 96, 128}) through
               ``fusion_sim_torch.examples.mxu_experiment.make_bench``: one
               launch a variant, checked against the plain version, then
               ms (median of 20), G rows/s, bound, share of bound and the
               library time (``torch.matmul`` + sums);
10. fast path — ``enable_fast_path()`` on the default scenario at
               1,048,576 protons (400 x 800, dt 2e-9), bench.py's
               headline: one warm batch of 50 steps, four timed batches,
               pushes/s, finite state, alive fraction, respawns inside the
               source box; bench.py's drift check (256 protons, no sinks,
               10,000 substeps, max |dv|/v < 1e-3); one profiled batch;
11. EM repair — examples/bench_em_fused.py's repair rung: 10,002,432
               particles, 512^2, ``Tiling2D(16, 16, 1024, margin=7)``,
               ``repair=True``, resort 1e9, ``gather_backend='fused'``: one
               warm and two timed windows of 12 steps; B4 launches, drops,
               validity, finiteness and Gauss's law checked, ``unplaced``
               printed, steps/s beside phase 6's resort-12 figure, B4 held
               bit for bit against its plain version and timed against its
               bound on the rung's own inputs, one profiled window;
12. viewer   — the reference app's live mode: the spindle BEM at n_power
               3 on 400 x 800 timed (matrix, solve, grid field) and its
               normal-field cancellation checked; then
               ``fusion_sim_torch.viewer.server`` served in this process
               on 127.0.0.1:0 and driven over HTTP: the default scenario at
               16,810,000 protons, the spindle field (n_power 3), the fast
               path refused, the sorted path (``backend='fused'``, resort
               10, spill 16384), ``/api/step`` n=20 (steps/s, two B2
               launches a step), ``/api/start`` for ~3.5 s and
               ``/api/stop`` (fps > 0 while running, 0 after; B2 launches
               two a step), no row dropped, ``/frame.png`` decoded to 800
               x 400 RGB, finite diagnostics, the ms of a render + PNG
               encode and which encoder ran; then ES ``two_stream`` and EM
               ``weibel`` at their factory sizes, 5 steps and a frame each;
13. bench    — ``python -m fusion_sim_torch.bench`` in a process of its own
               at full size: it must exit 0 and print one JSON line with
               exactly bench.py's keys, every section a number (no
               ``failed``, ``null`` or skipped section), no rung dropping
               rows, the parity drift < 1e-3 and the updates/s = the ES
               steps/s x 9,999,360; the line and each section's seconds
               and launches are logged;
14. examples — each ported example's ``main`` once at its default width:
               two_stream (800 steps, the fitted rate within 10% of
               theory), weibel (a linear phase with a positive rate),
               default_scenario (its PPM frame decodes), bench_es_fused,
               bench_em_fused (fused and pallas), bench_pusher (fused and
               pallas) and bench_3d (es, em) with ``--steps 2``,
               drift_control f32 and f64 (300 steps), bench_slab_capacity
               (124,999,680 particles, peak memory printed), and
               bench_sharded_1chip (--model em in 2D and 3D, --mesh2d for
               ES and EM; the sharded and single-device steps and their
               ratio, no overflow, drops printed) and bench_weak_scaling
               --devices 1, each with --steps 2; no row dropped on the
               single-device benches, each path's kernels launched; then
               the probe, microbench and profiling examples at their
               defaults (probe_es_spill, probe_pusher_flux --fine,
               probe_pusher_matrix, bench_resort -- also at 10,002,432
               rows and at 29,997,056 rows on the 3D layout --,
               bench_gather, bench_rng, profile_es_step, profile_pusher,
               profile_repair, profile_kernels for each of B1, B4, B5, B6
               and B2, probe_kernel_floor), every printed figure finite;
               probe_es_spill's printed peak and drop totals equal to the
               model's counters, probe_pusher_matrix naming a rung with
               no drops or none, probe_kernel_floor's no_both build
               faster than the full kernel;
15. sharded  — ``ShardedElectrostaticPIC(backend='pallas')`` in a world of
               one (NCCL, started by ``parallel.mesh.make_mesh``) at the ES
               half of the reference's one-chip sharded bench: 2D at
               10,002,432 particles on 512^2 (B1), the same with
               ``repair=True`` after a 117-step warm-up, and 3D at
               29,997,056 on 128^3 (B5).  Each holds its kernel bit for bit
               (rho within 1e-5 of its max) against the plain version on
               the shard's pseudo-grid inputs, holds its carried rho within
               1e-5 of its max against a fresh deposit in its own frame,
               holds 4 steps against ``SortedElectrostaticPIC(backend=
               'pallas')`` from the same positions (kinetic energy within
               1e-5, sorted positions within 1e-3 of a cell, rho within
               1e-4 of its max: the shard's frame x + halo rounds to f32
               each step), needs no overflow (no particle lost) and a move
               under the halo's bound (min(slab/2, halo_w - 1) cells a
               step; the reference's disp_bound of 1 cell is shown), and
               prints steps/s, ms a step, the rows
               dropped past the spill capacity in both models (the 2D
               rung's configuration drops late in a window) and the repair
               rung's unplaced rows, the kernel's
               launches and ms, the ratio to the single-device fused step,
               the step's pieces (frame shift, solve, kernel, spill mask,
               wrap back) in ms and one profiled window;
16. sharded EM and two-axis — in a world of one again, the EM half and
               the --mesh2d forms of the reference's one-chip sharded
               bench, built by ``examples/bench_sharded_1chip.build_sim``:
               ``ShardedElectromagneticPIC(gather_backend='fused')`` at
               10,002,432 particles on 512^2 (B4, resort 12), its repair
               form (resort 1e9) and 29,997,056 on 128^3 (B6, resort 6);
               ``ShardedElectrostaticPIC2D(backend='pallas')`` and
               ``ShardedElectromagneticPIC2D(gather_backend='fused')`` on a
               (1, 1) mesh in 2D (B1, B4) and 3D (B5, B6).  Each holds its
               kernel bit for bit (the deposit within 1e-5 of its max)
               against the plain version on the shard's pseudo-grid
               inputs; the 2D runs and the EM slab 3D run hold 4 steps
               against the single-device fused model (EM: the first
               step's J within 1e-4 of its max from positions the shard's
               frame holds exactly, then kinetic and field energy within
               1e-5 and sorted positions within 1e-3 of a cell; ES as
               phase 15), the two-axis 3D runs take 2 steps on their
               invariants; every run needs no overflow and a move under
               the halo's bound, and prints steps/s and ms a step of both
               models and their ratio, the drops (and unplaced rows), the
               kernel's launches and ms against its bound and one profiled
               window's device busy share;
17. dry run  — ``fusion_sim_torch.entry.dryrun_multichip(1)`` in a world
               of one (NCCL): every section of the reference's dry run
               with its asserts (the data-parallel pusher and EM steps,
               the sharded EM and ES models plain, sorted, fused and
               repair, the 3D fused shards, the halo and migration calls;
               2e needs an even count), each fused section's kernel (B1,
               B4, B5, B6) held bit for bit against its plain version at
               the section's shapes and timed; config[4]'s memory table
               (``examples/config4_evidence.hbm_budget``) beside the slab
               rung's peak measured in phase 14, and its 1/8-scale run at
               one shard (overflow 0, every particle alive, KE ratio);
               then the total time.

The line before the last lists the kernels as JSON (B3 once a form: the
pusher's nearest C = 12 and C = 1, the EM route's cic C = 6; X1 with its
sweep's launches and the numbers of its lhs_k_lanes / highest / K = 128
variant; B1's three ablated builds beside B1, with their launches in
probe_kernel_floor; B1 and B5 again for each run of phase 15, B1, B4, B5
and B6 for each run of phase 16 and for each fused section of the dry
run); the last line is the result: ``{"ok": true,
"device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events).  Each
    run is queued behind ~0.5 ms of device sleep, so the host's own work
    in ``fn`` (a wrapper's checks and allocations, the launch) overlaps the
    sleep and stays out of the time; a kernel shorter than that host work
    is otherwise timed at the host's pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def zero_counts(kernel_modules) -> None:
    """Every kernel's launch count (and B3's counts by form) to 0, just
    before a path is driven."""
    for mod in kernel_modules:
        mod.LAUNCHES = 0
        getattr(mod, "FORM_LAUNCHES", {}).clear()


def resort_launches(kernel_modules, resorts: int, where: str,
                    per: int = 3) -> int:
    """The bucket resort's launches since ``zero_counts``: three a resort on
    a main path with rows by tile, four by cell (``per``)."""
    tb = next(m for m in kernel_modules
              if m.__name__.endswith(".tile_bucket"))
    if tb.LAUNCHES != per * resorts:
        raise AssertionError(f"{where}: bucket resort launches "
                             f"{tb.LAUNCHES} != {per} x {resorts} resorts")
    return tb.LAUNCHES


def bound(bytes_moved: float, ops: float):
    """(ms, 'bytes'|'operations'): the larger of bytes over the H100's
    memory rate and f32 operations over its peak f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def profile_window(torch, phase, label, fn):
    """One profiled window: device time by kernel and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        log(phase, "profiler recorded no device time: breakdown not "
                   "measured")
        return None
    n_ops = sum(r[1] for r in rows)
    log(phase, f"profiled window ({label}): wall {wall_ms:.2f} ms "
               f"(profiler on), device busy {busy:.2f} ms "
               f"({100 * busy / wall_ms:.1f}%), {n_ops} device ops")
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        log(phase, f"  {ms:9.3f} ms {count:5d}x {key[:90]}")
    return n_ops


# -- ES (kernel B1) ------------------------------------------------------------

def compare_substep(torch, fp, args, tol_rho=1e-5, atol=1e-5):
    """B1 vs plain on the same inputs; returns (max_abs_err, report).
    Launches made here are not part of any counted run."""
    k = fp.fused_es2d_substep(*args)
    p = fp.fused_es2d_substep_plain(*args)
    torch.cuda.synchronize()
    valid = args[3] != 0
    flips = int(((k[3] != p[3]) & valid).sum())
    if flips:
        raise AssertionError(f"in_win differs on {flips} valid rows")
    err_pos = float((k[0] - p[0])[valid].abs().max())
    err_vel = float((k[1] - p[1])[valid].abs().max())
    rho_scale = float(p[2].abs().max())
    err_rho = float((k[2] - p[2]).abs().max())
    if not (err_pos <= atol and err_vel <= atol):
        raise AssertionError(f"pos/vel differ: {err_pos} {err_vel} > {atol}")
    if not err_rho <= tol_rho * rho_scale:
        raise AssertionError(f"rho differs: {err_rho} > {tol_rho} * "
                             f"{rho_scale}")
    spilled = int((~p[3] & valid).sum())
    return max(err_pos, err_vel), (
        f"in_win flips 0, spilled rows {spilled}, max|dpos| {err_pos:.3g}, "
        f"max|dvel| {err_vel:.3g}, max|drho| {err_rho:.3g} "
        f"(max|rho| {rho_scale:.3g}, tol {tol_rho:g} relative)")


def compare_ablated(torch, fp, args, charged, ablate):
    """B1's ablated build against the ablated plain version on the same
    inputs: in_win, positions and velocities bit for bit on every row, rho
    within 1e-5 of its max ('no_gather') or exactly 0 (no deposit)."""
    k = fp.fused_es2d_substep(*args, ablate=ablate)
    p = fp.fused_es2d_substep_plain(*args, ablate=ablate)
    err, report = compare_fused(torch, f"B1 {ablate}", k, p, charged, "rho")
    if ablate != "no_gather" and (bool(k[2].any()) or bool(p[2].any())):
        raise AssertionError(f"B1 {ablate}: rho is not zero")
    return err, report


def substep_bound_ms(n_rows: int, n_valid: int, shape, block: int):
    """Least time for one B1 substep: each row's position, velocity and
    weight read once and position, velocity and in_win written once, the
    E grid read once, rho written once, one tile id per block; against
    ~60 f32 operations per weighted row."""
    nr, nz = shape
    bytes_moved = (n_rows * (8 + 8 + 4 + 8 + 8 + 1) + nr * nz * (8 + 4)
                   + (n_rows // block) * 4)
    return (*bound(bytes_moved, 60 * n_valid), bytes_moved)


def phase3_es(torch, es, fp, Tiling2D, build_padded_layout, dev, tiling):
    from fusion_sim_torch.bench import es_config

    shape = (512, 512)
    rng = np.random.default_rng(1)
    n3 = 1 << 20
    cfg3 = es_config(n3)
    qm_dt = cfg3.charge / cfg3.mass * cfg3.dt
    c_ax = cfg3.dt / cfg3.cell_size[0]
    pos = torch.tensor(rng.random((n3, 2), dtype=np.float32) * 512,
                       device=dev)
    e_grid = torch.tensor(rng.standard_normal((512, 512, 2),
                                              dtype=np.float32), device=dev)
    for case, vscale in (("thermal", 0.05), ("spill", 4.0)):
        vel = torch.tensor(vscale * rng.standard_normal((n3, 2),
                                                        dtype=np.float32),
                           device=dev)
        tid, pos_p, v0, v1, valid, _ = build_padded_layout(
            pos, shape, tiling, vel[:, 0], vel[:, 1], derive_valid=True)
        w = torch.where(valid, 1.0, 0.0).to(torch.float32)
        args = (e_grid, pos_p, torch.stack([v0, v1], -1).contiguous(), w,
                tid, shape, tiling, qm_dt, c_ax, c_ax)
        _, report = compare_substep(torch, fp, args)
        k_ms = median_ms(torch, lambda: fp.fused_es2d_substep(*args))
        p_ms = median_ms(torch, lambda: fp.fused_es2d_substep_plain(*args))
        b_ms, b_by, _ = substep_bound_ms(pos_p.shape[0], int(valid.sum()),
                                         shape, tiling.block)
        log("3 kernels", f"es2d_substep {case} ({pos_p.shape[0]} rows): "
                         f"{report}; kernel {k_ms:.4f} ms, plain "
                         f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        for ablate in ("no_gather", "no_deposit", "no_both"):
            _, report = compare_ablated(torch, fp, args, valid, ablate)
            log("3 kernels", f"es2d_substep {case} ablate={ablate}: "
                             f"{report}")

    n_small, cells = 16384, 64
    cfg_s = es_config(n_small, cells)
    rng = np.random.default_rng(2)
    pos_s = (rng.random((n_small, 2)) * cells).astype(np.float32)
    vel_s = (0.3 * rng.standard_normal((n_small, 2))).astype(np.float32)
    kw = dict(tiling=Tiling2D(16, 16, 256, margin=2), resort_every=4,
              spill_capacity=4096, spill_tiers=(64, 512), check_spill=False,
              backend="pallas")
    card_vs_cpu(torch, "small ES run (pallas)",
                es.SortedElectrostaticPIC(cfg_s, pos_s, vel_s, device="cpu",
                                          **kw),
                lambda blob: es.SortedElectrostaticPIC.from_state(
                    cfg_s, blob, device="cuda", **kw), ("rho",), 10, n_small)


def phase4_es_main(torch, es, fp, smi, kernel_modules):
    from fusion_sim_torch import bench as pb

    n = pb.N_ES
    t0 = time.perf_counter()
    resort = pb.ES_RESORT
    sim = pb.build_es_sim(backend="pallas", precision=pb.ES_PRECISION,
                          margin=pb.ES_MARGIN, resort=resort,
                          spill_tiers=pb.ES_SPILL_TIERS)
    cfg, tiling = sim.config, sim.tiling
    torch.cuda.synchronize()
    log("4 ES", f"set-up {time.perf_counter() - t0:.2f} s ({n} particles, "
                f"{sim.state.position.shape[0]} layout rows)")
    t0 = time.perf_counter()
    sim.step(resort)
    torch.cuda.synchronize()
    log("4 ES", f"warm window ({resort} steps + resort) "
                f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernel_modules)
    rates, steps = [], 0
    for _ in range(2):
        t0 = time.perf_counter()
        sim.step(resort)
        torch.cuda.synchronize()
        rates.append(resort / (time.perf_counter() - t0))
        steps += resort
    launches = fp.LAUNCHES
    if launches != steps:
        raise AssertionError(f"kernel launches {launches} != steps {steps}")
    resorted = resort_launches(kernel_modules, steps // resort, "4 ES")
    st = sim.state
    if st.spill_dropped != 0:
        raise AssertionError(f"{st.spill_dropped} spilled rows dropped")
    for name in ("position", "velocity", "rho"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"state.{name} is not finite")
    n_valid = int(st.valid.sum())
    if n_valid != n:
        raise AssertionError(f"{n_valid} valid rows, expected {n}")
    w0 = cfg.charge / cfg.cell_volume
    q = float(st.rho.double().sum())
    rel = abs(q - n * w0) / abs(n * w0)
    if rel > 1e-5:
        raise AssertionError(f"charge {q} vs n*w0 {n * w0}: {rel:.3g} "
                             f"relative")
    rate = float(np.median(rates))
    log("4 ES", f"{smi}: {steps} timed steps, windows "
                f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, median "
                f"{rate:.3f} steps/s = {rate * n:.4g} particle updates/s; "
                f"launches {launches}, bucket resort {resorted}; spill "
                f"patched {st.spill}, dropped "
                f"{st.spill_dropped}; charge error {rel:.3g} relative; peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # kernel vs plain and bound, on the main path's own inputs
    rho = st.rho - torch.sum(st.rho) / math.prod(cfg.grid_shape)
    _, e_grid = es.solve_fields(cfg, rho)
    w = torch.where(st.valid, w0, 0.0).to(torch.float32)
    args = (e_grid, st.position, st.velocity, w, st.tile_id, cfg.grid_shape,
            tiling, cfg.charge / cfg.mass * cfg.dt,
            cfg.dt / cfg.cell_size[0], cfg.dt / cfg.cell_size[1])
    err, report = compare_substep(torch, fp, args)
    k_ms = median_ms(torch, lambda: fp.fused_es2d_substep(*args))
    p_ms = median_ms(torch, lambda: fp.fused_es2d_substep_plain(*args),
                     reps=20, warm=1)
    b_ms, b_by, b_bytes = substep_bound_ms(st.position.shape[0], n_valid,
                                           cfg.grid_shape, tiling.block)
    log("4 ES", f"es2d_substep on the main path's inputs "
                f"({st.position.shape[0]} rows): {report}; kernel "
                f"{k_ms:.4f} ms ({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s "
                f"effective), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by})")
    # the ablated builds on the same inputs: what the gather and the
    # deposit cost (their launches come from phase 14's probe_kernel_floor)
    ablations = []
    for ablate in ("no_gather", "no_deposit", "no_both"):
        a_err, report = compare_ablated(torch, fp, args, st.valid, ablate)
        a_ms = median_ms(torch, lambda: fp.fused_es2d_substep(
            *args, ablate=ablate))
        ap_ms = median_ms(torch, lambda: fp.fused_es2d_substep_plain(
            *args, ablate=ablate), reps=5, warm=1)
        log("4 ES", f"es2d_substep ablate={ablate} on the main path's "
                    f"inputs: {report}; kernel {a_ms:.4f} ms ({a_ms / k_ms:.3f}"
                    f" of the full kernel's {k_ms:.4f}), plain {ap_ms:.4f} ms")
        ablations.append({
            "name": f"B1:es2d_substep ablate={ablate}", "route": "cuda",
            "source": "fusion_sim_torch/csrc/es2d_substep.cu",
            "replaces": "fusion_sim_tpu/ops/pallas_pic.py:271",
            "launches": 0, "max_abs_err": a_err, "ms": a_ms,
            "plain_ms": ap_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    solve_ms = median_ms(torch, lambda: es.solve_fields(cfg, rho))
    log("4 ES", f"solve_fields (cuFFT, 512^2) {solve_ms:.4f} ms")
    profile_window(torch, "4 ES", f"{resort} steps + resort",
                   lambda: sim.step(resort))
    return {
        "name": "B1:es2d_substep", "route": "cuda",
        "source": "fusion_sim_torch/csrc/es2d_substep.cu",
        "replaces": "fusion_sim_tpu/ops/pallas_pic.py:271",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }, ablations, resorted


# -- pusher (kernels B2, B3) ----------------------------------------------------

def packed13(torch, fields):
    c = fields.coeffs
    return torch.cat([c.r1, c.r2, c.r3, c.a, fields.sink_mask[..., None]],
                     dim=-1).contiguous()


def compare_pusher(torch, fpu, args, valid, rel=1e-6):
    """B2 vs plain on the same inputs: in_win and sink equal on every valid
    row, positions and velocities within ``rel`` of their scale (expected
    0: -fmad=false).  Returns (max_abs_err, report)."""
    k = fpu.fused_pusher_substep(*args)
    p = fpu.fused_pusher_substep_plain(*args)
    torch.cuda.synchronize()
    for name, i in (("in_win", 3), ("sink", 2)):
        bad = int(((k[i] != p[i]) & valid).sum())
        if bad:
            raise AssertionError(f"B2 {name} differs on {bad} valid rows")
    errs = []
    for name, i in (("position", 0), ("velocity", 1)):
        err = float((k[i] - p[i])[valid].abs().max())
        scale = float(p[i][valid].abs().max())
        if not err <= rel * scale:
            raise AssertionError(f"B2 {name} differs by {err} (scale "
                                 f"{scale})")
        errs.append(err)
    spilled = int((~p[3] & valid).sum())
    return max(errs), (f"in_win and sink equal, spilled rows {spilled}, "
                       f"max|dpos| {errs[0]:.3g}, max|dvel| {errs[1]:.3g}")


def pusher_bound_ms(n_rows: int, n_fresh: int, shape, block: int):
    """Least time for one B2 half-step: position, velocity and alive read
    once, 12 B of uniforms for each fresh row, position, velocity, sink and
    in_win written once, the 13-channel table read once, one tile id a
    block; against ~60 f32 operations a row."""
    nr, nz = shape
    bytes_moved = (n_rows * (12 + 12 + 4) + n_fresh * 12
                   + n_rows * (12 + 12 + 4 + 1) + nr * nz * 13 * 4
                   + (n_rows // block) * 4)
    return (*bound(bytes_moved, 60 * n_rows), bytes_moved)


def compare_gather(torch, sg, args, valid):
    """B3 vs plain: in_win equal on every row, values equal on valid rows
    up to 1e-6 of their scale (expected 0).  Returns (max_abs_err,
    report)."""
    k = sg.gather_sorted_2d_window(*args)
    p = sg.gather_sorted_2d_window_plain(*args)
    torch.cuda.synchronize()
    bad = int((k[1] != p[1]).sum())
    if bad:
        raise AssertionError(f"B3 in_win differs on {bad} rows")
    err = float((k[0] - p[0])[valid].abs().max())
    scale = float(p[0][valid].abs().max())
    if not err <= 1e-6 * scale:
        raise AssertionError(f"B3 values differ by {err} (scale {scale})")
    out = int((~p[1] & valid).sum())
    return err, (f"in_win equal, out-of-window rows {out}, max|dvalue| "
                 f"{err:.3g}")


def gather_bound_ms(n_rows: int, n_c: int, shape, block: int, mode: str):
    """Least time for one B3 gather: positions read once, C values and
    in_win written once, the C-channel grid read once, one tile id a
    block; against ~4 (nearest) or ~20 (cic) f32 operations a value."""
    nr, nz = shape
    bytes_moved = (n_rows * (8 + 4 * n_c + 1) + nr * nz * n_c * 4
                   + (n_rows // block) * 4)
    ops = n_rows * (10 + n_c * (4 if mode == "nearest" else 20))
    return (*bound(bytes_moved, ops), bytes_moved)


def phase3_pusher(torch, pm, ps, sc, fpu, sg, Tiling2D, dev):
    from fusion_sim_torch import bench as pb
    from fusion_sim_torch.ops.boris import pack_coefficients
    from fusion_sim_torch.ops.fused_pusher import cell_coords

    # the bench's 16.8 M fused rung at 1,048,576 protons
    sim = pb.build_sorted_sim(1024, resort_every=10, spill_capacity=16384)
    shape = (sim.spec.nr, sim.spec.nz)
    tiling = sim._sorted_tiling
    if tiling != Tiling2D(8, 100, 1024, 6):
        raise AssertionError(f"fused default tiling {tiling}")
    st = sim._sorted_state
    table = packed13(torch, sim.fields)
    gen = torch.Generator(device=dev).manual_seed(11)
    rand = torch.rand((st.position.shape[0], 4), generator=gen, device=dev)
    fresh = st.alive.clone()
    fresh[st.valid.nonzero()[::97, 0]] = 0.0       # ~1% fresh rows
    for case, vel, alive in (("scenario", st.velocity, st.alive),
                             ("heavy spill", st.velocity * 40.0, fresh)):
        args = (table, st.position, vel.contiguous(), alive, rand,
                st.tile_id, shape[0], shape[1], tiling,
                sim.spec.step_factor)
        _, report = compare_pusher(torch, fpu, args, st.valid)
        k_ms = median_ms(torch, lambda: fpu.fused_pusher_substep(*args))
        p_ms = median_ms(torch, lambda: fpu.fused_pusher_substep_plain(
            *args), reps=5, warm=1)
        b_ms, b_by, _ = pusher_bound_ms(st.position.shape[0],
                                        int((alive <= 0.5).sum()), shape,
                                        tiling.block)
        log("3 kernels", f"pusher_substep {case} ({st.position.shape[0]} "
                         f"rows, tiling {tiling.tile_r}x{tiling.tile_z}): "
                         f"{report}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                         f"ms, bound {b_ms:.4f} ms ({b_by})")

    sim.enable_sorted_path(backend="pallas", resort_every=12,
                           spill_capacity=8192, respawn_capacity=512)
    tiling = sim._sorted_tiling
    if tiling != Tiling2D(50, 50, 1024, 4):
        raise AssertionError(f"pallas default tiling {tiling}")
    st = sim._sorted_state
    cell = cell_coords(st.position, *shape)
    rng = np.random.default_rng(12)
    jitter = torch.remainder(
        cell + torch.tensor(1.5 * rng.standard_normal(cell.shape),
                            dtype=torch.float32, device=dev),
        torch.tensor(shape, dtype=torch.float32, device=dev)).contiguous()
    grid6 = torch.tensor(rng.standard_normal(shape + (6,)),
                         dtype=torch.float32, device=dev)
    for label, grid, pos, mode in (
            ("nearest C=12", pack_coefficients(sim.fields.coeffs), cell,
             "nearest"),
            ("nearest C=1", sim.fields.sink_mask[..., None], cell,
             "nearest"),
            ("cic C=6 (jittered)", grid6, jitter, "cic")):
        args = (grid, pos, st.tile_id, shape, tiling, mode)
        _, report = compare_gather(torch, sg, args, st.valid)
        k_ms = median_ms(torch, lambda: sg.gather_sorted_2d_window(*args))
        p_ms = median_ms(torch, lambda: sg.gather_sorted_2d_window_plain(
            *args), reps=5, warm=1)
        n_c = grid.shape[2]
        b_ms, b_by, _ = gather_bound_ms(pos.shape[0], n_c, shape,
                                        tiling.block, mode)
        log("3 kernels", f"gather2d {label} ({pos.shape[0]} rows, tiling "
                         f"50x50): {report}; kernel {k_ms:.4f} ms, plain "
                         f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del sim, st

    # a small pusher run on the card against the same run on the CPU: the
    # same carried state and fields, the same uniforms, a resort between
    small = dict(nr=64, nz=128)
    cpu = sc.build_default_sim(32, device="cpu", **small)
    rng = np.random.default_rng(13)
    n = cpu.spec.n_total
    r = np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    cpu.set({"position": np.stack([r * np.cos(th), r * np.sin(th),
                                   2 * rng.random(n)], -1),
             "velocity": 0.02 * rng.standard_normal((n, 3))})
    gpu = pm.CylindricalParticlePusher(dict(sc.DEFAULT_SPEC, nparticles=32,
                                            **small), device="cuda")
    gpu.set_state(cpu.get_state())
    tiling = Tiling2D(8, 16, 128, 3)
    for backend in ("fused", "pallas"):
        step = ps.make_sorted_step_fn(cpu.spec, tiling, 4096, backend)
        resort = ps.make_sorted_resort_fn(cpu.spec, tiling)
        st_c = ps.to_sorted_state(cpu.state, cpu.spec, tiling)
        st_g = ps.to_sorted_state(gpu.state, gpu.spec, tiling)
        gen = torch.Generator().manual_seed(7)
        for s in range(6):
            rands = [torch.rand((st_c.position.shape[0], 4), generator=gen)
                     for _ in range(2)]
            st_c = step(cpu.fields, st_c, rands)
            st_g = step(gpu.fields, st_g, [x.to(dev) for x in rands])
            if s == 2:
                st_c, st_g = resort(st_c), resort(st_g)
        for name in ("tile_id", "valid", "alive"):
            if not torch.equal(getattr(st_c, name),
                               getattr(st_g, name).cpu()):
                raise AssertionError(f"small {backend} run: {name} differs "
                                     f"between card and CPU")
        counts = [(getattr(st_c, k), getattr(st_g, k))
                  for k in ("spill", "dropped", "dropped_over")]
        if any(a != b for a, b in counts):
            raise AssertionError(f"small {backend} run counters {counts}")
        errs = [float((getattr(st_g, k).cpu() - getattr(st_c, k)).abs()
                      .max()) for k in ("position", "velocity")]
        scales = [float(getattr(st_c, k).abs().max())
                  for k in ("position", "velocity")]
        if any(e > 1e-6 * s for e, s in zip(errs, scales)):
            raise AssertionError(f"small {backend} run: card vs CPU "
                                 f"position/velocity differ by {errs}")
        log("3 kernels", f"small pusher run ({backend}, {n} protons, 64 x "
                         f"128, 6 steps across a resort, spill "
                         f"{st_g.spill}, respawned rows now "
                         f"{int((st_g.alive == 0).sum())}): card vs CPU "
                         f"tile ids, validity, alive and counters equal, "
                         f"max|dpos| {errs[0]:.3g}, max|dvel| {errs[1]:.3g}")


def phase3_card_cases() -> None:
    """The B4, B5 and B3 cases of tests/test_torch_kernels_cuda.py on the
    card, in a process of their own: B4 in each of its forms by window, on
    tiles of ~20 blocks, the EM rungs' windows, rows by cell, windows read
    through L1, heavy spill with span rows and the repair layout, and its
    refused window; B5 on empty tiles, tiles of one block and of twenty, sentinel
    blocks, rows by tile, by cell and shuffled inside each tile, heavy
    spill, the largest windows and the smallest refused one; B3 with 1, 3,
    6, 12 and 13 channels in both modes and at the edges of its periodic
    wrap; the bucket resort against the sort, bit for bit; Y2 and T2
    against their plain versions and one fused 2D step through them, bit
    for bit."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "tests/test_torch_kernels_cuda.py", "-k",
         "em2d or es3d or gather2d or 3d_kernels_reject or tile_bucket or "
         "yee2d or node_table2d"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or "passed" not in lines[-1] \
            or "skipped" in lines[-1] or "failed" in lines[-1]:
        raise AssertionError("the B4/B5/B3/resort/Y2/T2 card cases failed:\n"
                             + "\n".join(lines[-40:]) + out.stderr[-2000:])
    log("3 kernels", f"B4, B5, B3, resort, Y2 and T2 card cases (tests/"
                     f"test_torch_kernels_cuda.py): {lines[-1]} "
                     f"({time.perf_counter() - t0:.1f} s)")


def run_windows(torch, sim, windows: int, cadence: int):
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        sim.step(cadence)
        torch.cuda.synchronize()
        rates.append(cadence / (time.perf_counter() - t0))
    return rates


def check_pusher_state(torch, st, n):
    if st.dropped != 0 or st.dropped_over != 0:
        raise AssertionError(f"dropped {st.dropped}, dropped_over "
                             f"{st.dropped_over}")
    n_valid = int(st.valid.sum())
    if n_valid != n:
        raise AssertionError(f"{n_valid} valid rows, expected {n}")
    for name in ("position", "velocity", "alive"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"sorted state {name} is not finite")


def phase5_fused(torch, fpu, Tiling2D, dev, smi, kernel_modules):
    from fusion_sim_torch import bench as pb

    t0 = time.perf_counter()
    cadence = 10
    # the bench's grid_mode_sorted_at_16m rung: 16,810,000 protons
    sim = pb.build_sorted_sim(4100, resort_every=cadence,
                              spill_capacity=16384)
    n = sim.spec.n_total
    torch.cuda.synchronize()
    st = sim._sorted_state
    rows = st.position.shape[0]
    expect = -(-n // 1024) * 1024 + 400 * 1024    # 17,220,608 at 4100^2
    if sim._sorted_tiling != Tiling2D(8, 100, 1024, 6) or rows != expect:
        raise AssertionError(f"layout {sim._sorted_tiling}, {rows} rows")
    log("5 pusher", f"set-up {time.perf_counter() - t0:.2f} s ({n} protons, "
                    f"400 x 800, {rows} layout rows, tiling 8 x 100 margin "
                    f"6, resort every {cadence}, spill capacity 16384)")
    t0 = time.perf_counter()
    sim.step(cadence)
    torch.cuda.synchronize()
    log("5 pusher", f"warm window ({cadence} steps + resort) "
                    f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    spill0 = sim._sorted_state.spill
    zero_counts(kernel_modules)
    rates = run_windows(torch, sim, 3, cadence)
    launches = fpu.LAUNCHES
    steps = 3 * cadence
    if launches != 2 * steps:
        raise AssertionError(f"B2 launches {launches} != 2 x {steps} steps")
    st = sim._sorted_state
    check_pusher_state(torch, st, n)
    rate = float(np.median(rates))
    log("5 pusher", f"{smi}: {steps} timed steps, windows "
                    f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, "
                    f"median {rate:.3f} steps/s = {2 * n * rate:.4g} "
                    f"pushes/s; B2 launches {launches}; spill patched "
                    f"{st.spill - spill0} rows ({(st.spill - spill0) / steps:.1f}"
                    f" a step), dropped {st.dropped}, dropped_over "
                    f"{st.dropped_over}; peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    frame = sim.density()
    torch.cuda.synchronize()
    if tuple(frame.shape) != (400, 800, 3) or not bool(
            torch.isfinite(frame).all()):
        raise AssertionError(f"density frame {tuple(frame.shape)} not "
                             f"finite/(400, 800, 3)")
    log("5 pusher", f"density frame (400, 800, 3) finite, max "
                    f"{float(frame.max()):.4g}")

    st = sim._sorted_state
    gen = torch.Generator(device=dev).manual_seed(21)
    rand = torch.rand((rows, 4), generator=gen, device=dev)
    args = (packed13(torch, sim.fields), st.position, st.velocity, st.alive,
            rand, st.tile_id, 400, 800, sim._sorted_tiling,
            sim.spec.step_factor)
    err, report = compare_pusher(torch, fpu, args, st.valid)
    k_ms = median_ms(torch, lambda: fpu.fused_pusher_substep(*args))
    p_ms = median_ms(torch, lambda: fpu.fused_pusher_substep_plain(*args),
                     reps=5, warm=1)
    b_ms, b_by, b_bytes = pusher_bound_ms(rows, int((st.alive <= 0.5).sum()),
                                          (400, 800), 1024)
    log("5 pusher", f"pusher_substep on the path's inputs ({rows} rows): "
                    f"{report}; kernel {k_ms:.4f} ms "
                    f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s effective), "
                    f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    profile_window(torch, "5 pusher", f"{cadence} steps + resort",
                   lambda: sim.step(cadence))
    return {
        "name": "B2:pusher_substep", "route": "cuda",
        "source": "fusion_sim_torch/csrc/pusher_substep.cu",
        "replaces": "fusion_sim_tpu/ops/pallas_pusher.py:206",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


def phase5b_pallas(torch, sg, smi, kernel_modules):
    from fusion_sim_torch import bench as pb
    from fusion_sim_torch.ops.boris import pack_coefficients
    from fusion_sim_torch.ops.fused_pusher import cell_coords

    t0 = time.perf_counter()
    cadence = 12
    # bench.py's 1,048,576-proton rung (resort 12, respawn 512) with the
    # patch buffer sized for this tiling: the rung's 8192 suits the fused
    # tiling's margin 6; at the pallas default's margin 4 late-window
    # substeps overflow it
    sim = pb.build_sorted_sim(1024, resort_every=cadence,
                              spill_capacity=32768, respawn_capacity=512,
                              backend="pallas")
    n = sim.spec.n_total
    st = sim._sorted_state
    rows = st.position.shape[0]
    sim.step(cadence)
    torch.cuda.synchronize()
    log("5b pallas", f"set-up and warm window {time.perf_counter() - t0:.2f}"
                     f" s ({n} protons, {rows} layout rows, tiling 50 x 50 "
                     f"margin 4, resort every {cadence}, spill capacity "
                     f"32768, respawn capacity 512)")
    spill0 = sim._sorted_state.spill
    zero_counts(kernel_modules)
    rates = run_windows(torch, sim, 2, cadence)
    launches = sg.LAUNCHES
    forms = dict(sg.FORM_LAUNCHES)
    steps = 2 * cadence
    # each half-step: the 12 field channels at the row, the sink at the
    # next position
    if launches != 4 * steps or forms != {"nearest C=12": 2 * steps,
                                          "nearest C=1": 2 * steps}:
        raise AssertionError(f"B3 launches {launches} ({forms}) != 2 + 2 "
                             f"a step over {steps} steps")
    st = sim._sorted_state
    check_pusher_state(torch, st, n)
    rate = float(np.median(rates))
    log("5b pallas", f"{smi}: {steps} timed steps, windows "
                     f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, "
                     f"median {rate:.3f} steps/s = {2 * n * rate:.4g} "
                     f"pushes/s; B3 launches {launches} ({forms}); spill "
                     f"patched {st.spill - spill0}, dropped {st.dropped}, "
                     f"dropped_over {st.dropped_over}")
    shape = (400, 800)
    nxt = st.position + sim.spec.step_factor * st.velocity
    records = []
    for form, label, grid, pos in (
            ("nearest C=12", "pusher", pack_coefficients(sim.fields.coeffs),
             cell_coords(st.position, *shape)),
            ("nearest C=1", "pusher sink", sim.fields.sink_mask[..., None],
             cell_coords(nxt, *shape))):
        args = (grid, pos, st.tile_id, shape, sim._sorted_tiling, "nearest")
        err, report = compare_gather(torch, sg, args, st.valid)
        if err != 0.0:
            raise AssertionError(f"B3 {form} differs from its plain version "
                                 f"by {err} on the path's inputs")
        k_ms = median_ms(torch, lambda: sg.gather_sorted_2d_window(*args))
        p_ms = median_ms(torch, lambda: sg.gather_sorted_2d_window_plain(
            *args), reps=5, warm=1)
        b_ms, b_by, b_bytes = gather_bound_ms(rows, grid.shape[2], shape,
                                              1024, "nearest")
        log("5b pallas", f"gather2d {form} ({label}) on the path's inputs "
                         f"({rows} rows): {report}; kernel {k_ms:.4f} ms "
                         f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s "
                         f"effective), plain {p_ms:.4f} ms, bound "
                         f"{b_ms:.4f} ms ({b_by})")
        records.append({
            "name": f"B3:gather2d ({label}, {form})", "route": "cuda",
            "source": "fusion_sim_torch/csrc/gather2d.cu",
            "replaces": "fusion_sim_tpu/ops/pallas_gather.py:98",
            "launches": forms[form], "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    profile_window(torch, "5b pallas", f"{cadence} steps + resort",
                   lambda: sim.step(cadence))
    return records


# -- EM (kernel B4, and B3 on the pallas route) ---------------------------------

def em_substep_args(cfg, tiling, table, st):
    return (table, st.position, st.velocity, st.valid, st.tile_id,
            cfg.grid_shape, tiling, cfg.charge / cfg.mass * cfg.dt * 0.5,
            cfg.dt, cfg.cell_size, cfg.charge)


def compare_fused(torch, label, k, p, charged, grid_name, tol=1e-5):
    """A fused substep's outputs ``k`` against its plain version's ``p``:
    in_win, positions and velocities bit for bit on every row, the
    deposited grid within ``tol`` of its max (atomic summation order).
    Returns (max_abs_err over rows, report)."""
    torch.cuda.synchronize()
    for name, i in (("in_win", 3), ("position", 0), ("velocity", 1)):
        bad = int((k[i] != p[i]).sum())
        if bad:
            raise AssertionError(f"{label} {name} differs on {bad} entries")
    err = float((k[2] - p[2]).abs().max())
    scale = float(p[2].abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{label} {grid_name} differs: {err} > {tol} * "
                             f"{scale}")
    spilled = int((~p[3] & charged).sum())
    err_rows = max(float((k[i] - p[i]).abs().max()) for i in (0, 1))
    return err_rows, (f"in_win, positions and velocities equal, spilled "
                      f"rows {spilled}, max|d{grid_name}| {err:.3g} "
                      f"(max|{grid_name}| {scale:.3g}, tol {tol:g} relative)")


def em_bound_ms(n_rows: int, n_valid: int, shape, block: int):
    """Least time for one B4 substep: position, velocity and valid read
    once and position, velocity and in_win written once (42 B a row), the
    6-channel table read once, J written once, one tile id a block; against
    ~300 f32 operations a charged row."""
    nr, nz = shape
    bytes_moved = (n_rows * (8 + 12 + 1 + 8 + 12 + 1) + nr * nz * (24 + 12)
                   + (n_rows // block) * 4)
    return (*bound(bytes_moved, 300 * n_valid), bytes_moved)


def sorted_gauss_residual(torch, em, sim):
    """max |div_Yee E - (rho - mean rho)/eps0| of a sorted EM model."""
    from fusion_sim_torch.ops.interp import cic_deposit

    st, cfg = sim.state, sim.config
    w = torch.where(st.valid, cfg.charge / cfg.cell_volume, 0.0)
    grid_f = torch.tensor(cfg.grid_shape, dtype=torch.float32,
                          device=st.position.device)
    rho = cic_deposit(torch.remainder(st.position, grid_f), w,
                      cfg.grid_shape)
    rho = rho - rho.mean()
    return float((em.yee_divergence(cfg, st.e) - rho / cfg.eps0).abs().max())


def phase3_em(torch, em, fe, Tiling2D, build_padded_layout, dev,
              n3: int = 1 << 20):
    from fusion_sim_torch.examples import bench_em_fused as bem

    em_config = bem.em_config
    tiling = Tiling2D(bem.TILE, bem.TILE, bem.BLOCK, margin=bem.MARGIN)
    shape = (512, 512)
    rng = np.random.default_rng(31)
    pos = torch.tensor(rng.random((n3, 2), dtype=np.float32) * 512,
                       device=dev)
    table = torch.tensor(rng.standard_normal((512, 512, 6),
                                             dtype=np.float32), device=dev)
    grid_f = torch.tensor(shape, dtype=torch.float32, device=dev)
    # heavy spill: drifts of ~8 cells against margin 6 (the deposit
    # criterion) on positions jittered by ~4 cells after the sort (the
    # gather criterion); c = 100 keeps the relativistic rows that fast
    for case, vscale, jitter, rel, c in (
            ("thermal", 0.05, 0.0, False, 1.0),
            ("thermal relativistic", 1.5, 0.0, True, 1.0),
            ("heavy spill", 40.0, 4.0, False, 1.0),
            ("heavy spill relativistic", 40.0, 4.0, True, 100.0)):
        cfg = em_config(relativistic=rel)
        vel = torch.tensor(vscale * rng.standard_normal((n3, 3),
                                                        dtype=np.float32),
                           device=dev)
        tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
            pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
            derive_valid=True)
        if jitter:
            pos_p = torch.remainder(
                pos_p + jitter * torch.tensor(
                    rng.standard_normal(tuple(pos_p.shape),
                                        dtype=np.float32), device=dev),
                grid_f).contiguous()
        st = em.SortedEMState(pos_p, torch.stack([v0, v1, v2],
                                                 -1).contiguous(), tid,
                              valid, None, None, 0, 0, 0)
        args = em_substep_args(cfg, tiling, table, st)
        kw = dict(c_light=c, relativistic=rel)
        _, report = compare_fused(
            torch, "B4", fe.fused_em2d_substep(*args, **kw),
            fe.fused_em2d_substep_plain(*args, **kw), args[3], "J")
        k_ms = median_ms(torch, lambda: fe.fused_em2d_substep(*args, **kw))
        p_ms = median_ms(torch, lambda: fe.fused_em2d_substep_plain(
            *args, **kw), reps=3, warm=1)
        b_ms, b_by, _ = em_bound_ms(pos_p.shape[0], int(valid.sum()), shape,
                                    tiling.block)
        log("3 kernels", f"em2d_substep {case} ({pos_p.shape[0]} rows): "
                         f"{report}; kernel {k_ms:.4f} ms, plain "
                         f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # small EM runs on the card against the same runs on the CPU: one
    # carried layout, a seeded wave so B acts from the first step, speeds
    # that spill past margin 2, 10 steps across two resorts
    n_small, cells = 16384, 64
    cfg_s = em_config(cells)
    rng = np.random.default_rng(32)
    pos_s = (rng.random((n_small, 2)) * cells).astype(np.float32)
    vel_s = (1.0 * rng.standard_normal((n_small, 3))).astype(np.float32)
    x = np.arange(cells) * 0.5
    e0 = np.zeros((cells, cells, 3), np.float32)
    b0 = np.zeros((cells, cells, 3), np.float32)
    e0[..., 1] = 0.05 * np.sin(2 * np.pi * x / (cells * 0.5))[:, None]
    b0[..., 2] = 0.05 * np.sin(2 * np.pi * x / (cells * 0.5))[:, None]
    for backend in ("xla", "pallas", "fused"):
        kw = dict(tiling=Tiling2D(16, 16, 256, margin=2), resort_every=4,
                  spill_capacity=4096, check_spill=False,
                  gather_backend=backend)
        card_vs_cpu(torch, f"small EM run ({backend})",
                    em.SortedElectromagneticPIC(cfg_s, pos_s, vel_s, e=e0,
                                                b=b0, device="cpu", **kw),
                    lambda blob: em.SortedElectromagneticPIC.from_state(
                        cfg_s, blob, device="cuda", **kw), ("e", "b"), 10,
                    n_small)


def check_em_state(torch, st, n):
    if st.spill_dropped != 0:
        raise AssertionError(f"{st.spill_dropped} spilled rows dropped")
    n_valid = int(st.valid.sum())
    if n_valid != n:
        raise AssertionError(f"{n_valid} valid rows, expected {n}")
    for name in ("position", "velocity", "e", "b"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"state.{name} is not finite")


def phase6_em_main(torch, em, fe, smi, kernel_modules):
    from fusion_sim_torch.examples import bench_em_fused as bem
    from fusion_sim_torch.ops import node_table2d as nt
    from fusion_sim_torch.ops import yee2d as y2

    n, resort = bem.N, bem.RESORT
    t0 = time.perf_counter()
    sim = bem.build_sim(n, backend="fused")
    torch.cuda.synchronize()
    cfg, tiling = sim.config, sim.tiling
    rows = sim.state.position.shape[0]
    log("6 EM", f"set-up {time.perf_counter() - t0:.2f} s ({n} particles, "
                f"512^2, {rows} layout rows, tile 32 margin 6, resort every "
                f"{resort}, spill capacity 16384)")
    r0 = sorted_gauss_residual(torch, em, sim)
    t0 = time.perf_counter()
    sim.step(resort)
    torch.cuda.synchronize()
    log("6 EM", f"warm window ({resort} steps + resort) "
                f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    zero_counts((*kernel_modules, y2, nt))
    rates = run_windows(torch, sim, 2, resort)
    launches = fe.LAUNCHES
    steps = 2 * resort
    if launches != steps or y2.LAUNCHES != steps or nt.LAUNCHES != steps:
        raise AssertionError(f"B4 launches {launches}, Y2 launches "
                             f"{y2.LAUNCHES}, T2 launches {nt.LAUNCHES} != "
                             f"steps {steps}")
    y_launches, t_launches = y2.LAUNCHES, nt.LAUNCHES
    resorted = resort_launches(kernel_modules, 2, "6 EM",
                               per=4)   # rows by cell
    st = sim.state
    check_em_state(torch, st, n)
    r1 = sorted_gauss_residual(torch, em, sim)
    if not r1 - r0 < 5e-3 * max(r0, 1.0):
        raise AssertionError(f"Gauss residual grew from {r0} to {r1}")
    rate = float(np.median(rates))
    en = sim.energies()
    log("6 EM", f"{smi}: {steps} timed steps, windows "
                f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, median "
                f"{rate:.3f} steps/s = {rate * n:.4g} particle updates/s; "
                f"B4 launches {launches}; spill patched {st.spill}, dropped "
                f"{st.spill_dropped}; Gauss residual {r0:.6g} -> {r1:.6g} "
                f"over {st.step} steps; field energy {en['field']:.6g}, "
                f"kinetic {en['kinetic']:.6g}; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # kernel vs plain and bound, on the main path's own inputs
    if not (bool(st.e.any()) and bool(st.b.any())):
        raise AssertionError("the path's E or B is all zero")
    table = nt.node_table_2d(st.e, st.b)
    plain_table = nt.node_table_2d_plain(st.e, st.b)
    torch.cuda.synchronize()
    if not torch.equal(table, plain_table):
        raise AssertionError("T2 differs from the plain node table")
    del plain_table
    args = em_substep_args(cfg, tiling, table, st)
    err, report = compare_fused(
        torch, "B4", fe.fused_em2d_substep(*args),
        fe.fused_em2d_substep_plain(*args), args[3], "J")
    k_ms = median_ms(torch, lambda: fe.fused_em2d_substep(*args))
    p_ms = median_ms(torch, lambda: fe.fused_em2d_substep_plain(*args),
                     reps=3, warm=1)
    b_ms, b_by, b_bytes = em_bound_ms(rows, n, cfg.grid_shape, tiling.block)
    log("6 EM", f"em2d_substep on the main path's inputs ({rows} rows): "
                f"{report}; kernel {k_ms:.4f} ms "
                f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s effective), "
                f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    c_ms = median_ms(torch, lambda: nt.node_table_2d_plain(st.e, st.b))
    t_ms = median_ms(torch, lambda: nt.node_table_2d(st.e, st.b))
    tb_ms, tb_by, tb_bytes = node_table_bound_ms(cfg.grid_shape)
    log("6 EM", f"T2 node_table2d (512^2): the table equals the plain "
                f"version's; kernel {t_ms:.4f} ms "
                f"({tb_bytes / (t_ms * 1e-3) / 1e9:.1f} GB/s effective, "
                f"{100 * tb_ms / t_ms:.1f}% of its bound), plain "
                f"(center_fields) {c_ms:.4f} ms, bound {tb_ms:.4f} ms "
                f"({tb_by})")
    # Y2 on the main path's fields and the J of B4's deposit on them
    j = fe.fused_em2d_substep(*args)[2]
    yee = (st.e, st.b, j, cfg.dt, cfg.cell_size, cfg.c, cfg.eps0)
    got, plain = y2.yee_update_2d(*yee), y2.yee_update_2d_plain(*yee)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
        raise AssertionError("Y2 differs from the plain Yee update")
    del got, plain
    y_ms = median_ms(torch, lambda: y2.yee_update_2d(*yee))
    yp_ms = median_ms(torch, lambda: y2.yee_update_2d_plain(*yee))
    yb_ms, yb_by, yb_bytes = yee_bound_ms(cfg.grid_shape)
    log("6 EM", f"Y2 yee2d (512^2): E and B equal the plain version's; "
                f"kernel {y_ms:.4f} ms "
                f"({yb_bytes / (y_ms * 1e-3) / 1e9:.1f} GB/s effective, "
                f"{100 * yb_ms / y_ms:.1f}% of its bound), plain "
                f"{yp_ms:.4f} ms, bound {yb_ms:.4f} ms ({yb_by})")
    del args, table, j, yee
    profile_window(torch, "6 EM", f"{resort} steps + resort",
                   lambda: sim.step(resort))
    y2_entry = {
        "name": "Y2:yee2d", "route": "cuda",
        "source": "fusion_sim_torch/csrc/yee2d.cu",
        "replaces": "none: the reference's yee_update is XLA",
        "launches": y_launches, "max_abs_err": 0.0, "ms": y_ms,
        "plain_ms": yp_ms, "bound_ms": yb_ms, "bound_by": yb_by,
        "library_ms": None,
    }
    t2_entry = {
        "name": "T2:node_table2d", "route": "cuda",
        "source": "fusion_sim_torch/csrc/node_table2d.cu",
        "replaces": "none: the reference's center_fields is XLA",
        "launches": t_launches, "max_abs_err": 0.0, "ms": t_ms,
        "plain_ms": c_ms, "bound_ms": tb_ms, "bound_by": tb_by,
        "library_ms": None,
    }
    return {
        "name": "B4:em2d_substep", "route": "cuda",
        "source": "fusion_sim_torch/csrc/em2d_substep.cu",
        "replaces": "fusion_sim_tpu/ops/pallas_em.py:256",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }, y2_entry, t2_entry, rate, resorted


def phase6b_em_pallas(torch, sg, smi, kernel_modules, n: int = 1 << 20):
    from fusion_sim_torch.examples import bench_em_fused as bem

    resort = bem.RESORT
    t0 = time.perf_counter()
    sim = bem.build_sim(n, backend="pallas")
    rows = sim.state.position.shape[0]
    sim.step(resort)
    torch.cuda.synchronize()
    log("6b EM pallas", f"set-up and warm window "
                        f"{time.perf_counter() - t0:.2f} s ({n} particles, "
                        f"{rows} layout rows)")
    zero_counts(kernel_modules)
    rates = run_windows(torch, sim, 2, resort)
    launches = sg.LAUNCHES
    steps = 2 * resort
    if launches != steps or sg.FORM_LAUNCHES != {"cic C=6": steps}:
        raise AssertionError(f"B3 launches {launches} "
                             f"({sg.FORM_LAUNCHES}) != steps {steps}")
    check_em_state(torch, sim.state, n)
    rate = float(np.median(rates))
    log("6b EM pallas", f"{smi}: {steps} timed steps, windows "
                        f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, "
                        f"median {rate:.3f} steps/s = {rate * n:.4g} "
                        f"particle updates/s; B3 launches {launches} (cic, 6 "
                        f"channels); spill patched {sim.state.spill}, "
                        f"dropped {sim.state.spill_dropped}")
    # kernel vs plain and bound, on this route's own inputs
    from fusion_sim_torch.ops import fdtd
    from fusion_sim_torch.ops.sorted_deposit import gather_sorted_2d

    st, cfg, tiling = sim.state, sim.config, sim.tiling
    table = fdtd.center_fields(st.e, st.b, fdtd.E_OFFSETS_2D,
                               fdtd.B_OFFSETS_2D)
    args = (table, st.position, st.tile_id, cfg.grid_shape, tiling, "cic")
    err, report = compare_gather(torch, sg, args, st.valid)
    if err != 0.0:
        raise AssertionError(f"B3 cic C=6 differs from its plain version by "
                             f"{err} on the EM route's inputs")
    k_val, k_inw = sg.gather_sorted_2d_window(*args)
    x_val, x_inw = gather_sorted_2d(*args[:5])
    rows_in = st.valid & k_inw
    err_x = float((k_val - x_val)[rows_in].abs().max())
    scale = float(x_val[rows_in].abs().max())
    # gather_sorted_2d takes the weights from x - floor(x), the kernel from
    # the window coordinate, which rounds to its own ulp (3.8e-6 cells at
    # l ~ 44): 1e-5 of the values' scale, as the CPU tests hold the two
    if not bool((k_inw == x_inw).all()) or not err_x <= 1e-5 * scale:
        raise AssertionError(f"B3 cic C=6 against gather_sorted_2d: in_win "
                             f"differs or values differ by {err_x} (scale "
                             f"{scale})")
    k_ms = median_ms(torch, lambda: sg.gather_sorted_2d_window(*args))
    p_ms = median_ms(torch, lambda: sg.gather_sorted_2d_window_plain(*args),
                     reps=5, warm=1)
    b_ms, b_by, b_bytes = gather_bound_ms(rows, 6, cfg.grid_shape,
                                          tiling.block, "cic")
    log("6b EM pallas", f"gather2d cic C=6 on the route's inputs ({rows} "
                        f"rows, tiling 32x32 margin 6): {report}; against "
                        f"gather_sorted_2d in_win equal, max|dvalue| "
                        f"{err_x:.3g} (scale {scale:.3g}, tol 1e-5 relative);"
                        f" kernel {k_ms:.4f} ms "
                        f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s "
                        f"effective), plain {p_ms:.4f} ms, bound {b_ms:.4f} "
                        f"ms ({b_by})")
    profile_window(torch, "6b EM pallas", f"{resort} steps + resort",
                   lambda: sim.step(resort))
    return {
        "name": "B3:gather2d (EM route, cic C=6)", "route": "cuda",
        "source": "fusion_sim_torch/csrc/gather2d.cu",
        "replaces": "fusion_sim_tpu/ops/pallas_gather.py:98",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }


# -- 3D (kernels B5, B6) ---------------------------------------------------------

def es3d_substep_args(torch, cfg, tiling, e_grid, st):
    w = torch.where(st.valid, cfg.charge / cfg.cell_volume, 0.0).to(
        torch.float32)
    return (e_grid, st.position, st.velocity, w, st.tile_id, cfg.grid_shape,
            tiling, cfg.charge / cfg.mass * cfg.dt,
            *(cfg.dt / d for d in cfg.cell_size))


def es3d_bound_ms(n_rows: int, n_valid: int, shape, block: int):
    """Least time for one B5 substep: position, velocity and weight read
    once and position, velocity and in_win written once (53 B a row), the
    3-channel E grid read once, rho written once, one tile id a block;
    against ~110 f32 operations a weighted row."""
    cells = math.prod(shape)
    bytes_moved = (n_rows * (12 + 12 + 4 + 12 + 12 + 1) + cells * (12 + 4)
                   + (n_rows // block) * 4)
    return (*bound(bytes_moved, 110 * n_valid), bytes_moved)


def em3d_bound_ms(n_rows: int, n_valid: int, shape, block: int):
    """Least time for one B6 substep: position, velocity and valid read
    once and position, velocity and in_win written once (50 B a row), the
    6-channel table read once, J written once, one tile id a block; against
    ~700 f32 operations a charged row (a 27-node stencil)."""
    cells = math.prod(shape)
    bytes_moved = (n_rows * (12 + 12 + 1 + 12 + 12 + 1) + cells * (24 + 12)
                   + (n_rows // block) * 4)
    return (*bound(bytes_moved, 700 * n_valid), bytes_moved)


def node_table_bound_ms(shape):
    """Least time for one node table: E and B read once and the table
    written once (48 B a node), against 24 f32 operations a node in 3D, 14
    in 2D."""
    cells = math.prod(shape)
    ops = 24 if len(shape) == 3 else 14
    return (*bound(cells * 48, cells * ops), cells * 48)


def yee_bound_ms(shape):
    """Least time for one Yee update: E, B and J read once and E and B
    written once (60 B a cell), against 54 f32 operations a cell in 3D, 57
    in 2D."""
    cells = math.prod(shape)
    ops = 54 if len(shape) == 3 else 57
    return (*bound(cells * 5 * 12, cells * ops), cells * 5 * 12)


def phase3_3d(torch, es, em, f3, fe3, Tiling3D, build_padded_layout, dev,
              n3: int = 1 << 20, cells: int = 64):
    from fusion_sim_torch.examples import bench_3d as b3d

    es3d_config, em3d_config = b3d.es_config, b3d.em_config
    tiling = Tiling3D((b3d.TILE,) * 3, b3d.BLOCK, margin=b3d.MARGIN)
    shape = (cells,) * 3
    rng = np.random.default_rng(41)
    pos = torch.tensor(rng.random((n3, 3), dtype=np.float32) * cells,
                       device=dev)
    grid_f = torch.tensor(shape, dtype=torch.float32, device=dev)

    def layout(vscale, jitter):
        vel = torch.tensor(vscale * rng.standard_normal((n3, 3),
                                                        dtype=np.float32),
                           device=dev)
        tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
            pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
            derive_valid=True)
        if jitter:
            pos_p = torch.remainder(
                pos_p + jitter * torch.tensor(
                    rng.standard_normal(tuple(pos_p.shape),
                                        dtype=np.float32), device=dev),
                grid_f).contiguous()
        return (pos_p, torch.stack([v0, v1, v2], -1).contiguous(), tid,
                valid)

    # B5: heavy spill = drifts of ~1.5 cells against margin 2 (the deposit
    # criterion) on positions jittered by ~1 cell after the sort (the
    # gather criterion)
    cfg = es3d_config(n3, cells)
    e_grid = torch.tensor(rng.standard_normal((*shape, 3), dtype=np.float32),
                          device=dev)
    for case, vscale, jitter in (("thermal", 0.05, 0.0),
                                 ("heavy spill", 3.0, 1.0)):
        pos_p, vel_p, tid, valid = layout(vscale, jitter)
        st = es.SortedESState(pos_p, vel_p, tid, valid, 0, 0, 0)
        args = es3d_substep_args(torch, cfg, tiling, e_grid, st)
        _, report = compare_fused(
            torch, "B5", f3.fused_es3d_substep(*args),
            f3.fused_es3d_substep_plain(*args), args[3] != 0, "rho")
        k_ms = median_ms(torch, lambda: f3.fused_es3d_substep(*args))
        p_ms = median_ms(torch, lambda: f3.fused_es3d_substep_plain(*args),
                         reps=3, warm=1)
        b_ms, b_by, _ = es3d_bound_ms(pos_p.shape[0], int(valid.sum()),
                                      shape, tiling.block)
        log("3 kernels", f"es3d_substep {case} ({pos_p.shape[0]} rows, "
                         f"{cells}^3): {report}; kernel {k_ms:.4f} ms, plain "
                         f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    # B5 at the slab's tiling ((8, 16, 16), margin 2) on a non-cubic grid:
    # bench_slab_capacity's rung cut to 128 x 128 x 64 with its cell, its
    # density and its speeds, held on the rows and E of one window
    from fusion_sim_torch.examples import bench_slab_capacity as slab

    sim = slab.build_sim(n=7_812_608, cells="128,128,64",
                         length=2 * np.pi * 128 / 512, device=dev)
    sim.step(sim.resort_every)
    st, cfg_s = sim.state, sim.config
    rho = st.rho - torch.sum(st.rho) / math.prod(cfg_s.grid_shape)
    _, e_slab = es.solve_fields(cfg_s, rho)
    args = es3d_substep_args(torch, cfg_s, sim.tiling, e_slab, st)
    _, report = compare_fused(
        torch, "B5", f3.fused_es3d_substep(*args),
        f3.fused_es3d_substep_plain(*args), args[3] != 0, "rho")
    log("3 kernels", f"es3d_substep slab tiling (8,16,16) margin 2 "
                     f"({st.position.shape[0]} rows, 128x128x64, after one "
                     f"window: spill {st.spill}, dropped "
                     f"{st.spill_dropped}): {report}")
    del sim, st, args, rho, e_slab

    # B6: heavy spill = rows that move ~1.6 cells a step (faster than a
    # cell, so the deposit walks more than 3 nodes an axis) from positions
    # jittered by ~1 cell; c = 100 keeps the relativistic rows that fast
    table = torch.tensor(rng.standard_normal((*shape, 6), dtype=np.float32),
                         device=dev)
    for case, vscale, jitter, rel, c in (
            ("thermal", 0.05, 0.0, False, 1.0),
            ("thermal relativistic", 1.5, 0.0, True, 1.0),
            ("heavy spill", 8.0, 1.0, False, 1.0),
            ("heavy spill relativistic", 8.0, 1.0, True, 100.0)):
        cfg = em3d_config(cells, relativistic=rel)
        pos_p, vel_p, tid, valid = layout(vscale, jitter)
        st = em.SortedEMState(pos_p, vel_p, tid, valid, None, None, 0, 0, 0)
        args = em_substep_args(cfg, tiling, table, st)
        kw = dict(c_light=c, relativistic=rel)
        _, report = compare_fused(
            torch, "B6", fe3.fused_em3d_substep(*args, **kw),
            fe3.fused_em3d_substep_plain(*args, **kw), args[3], "J")
        k_ms = median_ms(torch, lambda: fe3.fused_em3d_substep(*args, **kw))
        p_ms = median_ms(torch, lambda: fe3.fused_em3d_substep_plain(
            *args, **kw), reps=3, warm=1)
        b_ms, b_by, _ = em3d_bound_ms(pos_p.shape[0], int(valid.sum()),
                                      shape, tiling.block)
        log("3 kernels", f"em3d_substep {case} ({pos_p.shape[0]} rows, "
                         f"{cells}^3): {report}; kernel {k_ms:.4f} ms, plain "
                         f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # margin 7: a 23^3 window whose fields do not fit beside J in shared
    # memory, so the kernel reads the corners through L1
    wide = Tiling3D(tile=(8, 8, 8), block=512, margin=7)
    pos_w = torch.tensor(rng.random((n3 // 8, 3), dtype=np.float32) * cells,
                         device=dev)
    vel_w = torch.tensor(1.5 * rng.standard_normal((n3 // 8, 3),
                                                   dtype=np.float32),
                         device=dev)
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        pos_w, shape, wide, vel_w[:, 0], vel_w[:, 1], vel_w[:, 2],
        derive_valid=True)
    st = em.SortedEMState(pos_p, torch.stack([v0, v1, v2], -1).contiguous(),
                          tid, valid, None, None, 0, 0, 0)
    args = em_substep_args(em3d_config(cells), wide, table, st)
    _, report = compare_fused(torch, "B6", fe3.fused_em3d_substep(*args),
                              fe3.fused_em3d_substep_plain(*args), args[3],
                              "J")
    log("3 kernels", f"em3d_substep margin 7 (L1 corner reads, "
                     f"{pos_p.shape[0]} rows, {cells}^3): {report}")

    # small 3D runs on the card against the same runs on the CPU: one
    # carried layout, speeds that spill past margin 1, 7 steps across two
    # resorts
    n_small, cells = 8192, 16
    small = dict(tiling=Tiling3D((8, 8, 8), 128, margin=1), resort_every=3,
                 spill_capacity=4096, check_spill=False)
    rng = np.random.default_rng(42)
    pos_s = (rng.random((n_small, 3)) * cells).astype(np.float32)

    cfg_s = es3d_config(n_small, cells)
    vel_s = (3.0 * rng.standard_normal((n_small, 3))).astype(np.float32)
    kw = dict(small, backend="pallas", spill_tiers=(64, 512))
    card_vs_cpu(torch, "small 3D ES run",
                es.SortedElectrostaticPIC(cfg_s, pos_s, vel_s, device="cpu",
                                          **kw),
                lambda blob: es.SortedElectrostaticPIC.from_state(
                    cfg_s, blob, device="cuda", **kw), ("rho",), 7, n_small,
                need_spill=True)
    cfg_s = em3d_config(cells)
    vel_s = np.clip(1.5 * rng.standard_normal((n_small, 3)), -4.5,
                    4.5).astype(np.float32)
    x = np.arange(cells) * 0.5
    e0 = np.zeros((cells,) * 3 + (3,), np.float32)
    b0 = np.zeros((cells,) * 3 + (3,), np.float32)
    e0[..., 1] = 0.05 * np.sin(2 * np.pi * x / (cells * 0.5))[:, None, None]
    b0[..., 2] = 0.05 * np.sin(2 * np.pi * x / (cells * 0.5))[:, None, None]
    for backend in ("xla", "pallas", "fused"):
        kw = dict(small, gather_backend=backend)
        card_vs_cpu(torch, f"small 3D EM run ({backend})",
                    em.SortedElectromagneticPIC(cfg_s, pos_s, vel_s, e=e0,
                                                b=b0, device="cpu", **kw),
                    lambda blob: em.SortedElectromagneticPIC.from_state(
                        cfg_s, blob, device="cuda", **kw), ("e", "b"), 7,
                    n_small, need_spill=True)


def phase7_es3d_main(torch, es, f3, smi, kernel_modules):
    from fusion_sim_torch.examples import bench_3d as b3d

    n, resort, windows = b3d.N, b3d.RESORT, 3
    t0 = time.perf_counter()
    sim = b3d.build_sim("es", "pallas", n)
    cfg, tiling = sim.config, sim.tiling
    spill_capacity = sim.spill_capacity
    torch.cuda.synchronize()
    rows = sim.state.position.shape[0]
    log("7 ES 3D", f"set-up {time.perf_counter() - t0:.2f} s ({n} particles, "
                   f"128^3, {rows} layout rows, tile 8^3 block 512 margin 2, "
                   f"resort every {resort}, spill capacity {spill_capacity})")
    t0 = time.perf_counter()
    sim.step(resort)
    torch.cuda.synchronize()
    log("7 ES 3D", f"warm window ({resort} steps + resort) "
                   f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernel_modules)
    rates = run_windows(torch, sim, windows, resort)
    launches = f3.LAUNCHES
    steps = windows * resort
    if launches != steps:
        raise AssertionError(f"B5 launches {launches} != steps {steps}")
    resorted = resort_launches(kernel_modules, windows, "7 ES 3D",
                               per=4)  # by cell
    st = sim.state
    if st.spill_dropped != 0:
        raise AssertionError(f"{st.spill_dropped} spilled rows dropped")
    for name in ("position", "velocity", "rho"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"state.{name} is not finite")
    n_valid = int(st.valid.sum())
    if n_valid != n:
        raise AssertionError(f"{n_valid} valid rows, expected {n}")
    w0 = cfg.charge / cfg.cell_volume
    q = float(st.rho.double().sum())
    rel = abs(q - n * w0) / abs(n * w0)
    if rel > 1e-5:
        raise AssertionError(f"charge {q} vs n*w0 {n * w0}: {rel:.3g} "
                             f"relative")
    # the shell's layout orders each tile's rows by cell: after the window's
    # resort the real rows of a tile follow their cells
    from fusion_sim_torch.ops.sorted_deposit import (build_padded_layout,
                                                     tile_cell_keys)
    keys = tile_cell_keys(st.position, cfg.grid_shape, tiling)[st.valid]
    tids = st.tile_id[st.valid]
    unordered = int(((keys[1:] < keys[:-1]) & (tids[1:] == tids[:-1])).sum())
    if unordered:
        raise AssertionError(f"{unordered} real rows out of cell order "
                             f"after the resort")
    del keys, tids
    rate = float(np.median(rates))
    log("7 ES 3D", f"{smi}: {steps} timed steps, windows "
                   f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, median "
                   f"{rate:.3f} steps/s = {rate * n:.4g} particle updates/s; "
                   f"B5 launches {launches}; spill patched {st.spill}, "
                   f"dropped {st.spill_dropped} (capacity {spill_capacity}); "
                   f"charge error {rel:.3g} relative; peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # kernel vs plain and bound, on the main path's own inputs
    rho = st.rho - torch.sum(st.rho) / math.prod(cfg.grid_shape)
    _, e_grid = es.solve_fields(cfg, rho)
    args = es3d_substep_args(torch, cfg, tiling, e_grid, st)
    err, report = compare_fused(
        torch, "B5", f3.fused_es3d_substep(*args),
        f3.fused_es3d_substep_plain(*args), args[3] != 0, "rho")
    k_ms = median_ms(torch, lambda: f3.fused_es3d_substep(*args))
    p_ms = median_ms(torch, lambda: f3.fused_es3d_substep_plain(*args),
                     reps=3, warm=1)
    b_ms, b_by, b_bytes = es3d_bound_ms(rows, n_valid, cfg.grid_shape,
                                        tiling.block)
    log("7 ES 3D", f"es3d_substep on the main path's inputs ({rows} rows): "
                   f"{report}; kernel {k_ms:.4f} ms "
                   f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s effective), "
                   f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    solve_ms = median_ms(torch, lambda: es.solve_fields(cfg, rho))
    log("7 ES 3D", f"solve_fields (cuFFT, 128^3) {solve_ms:.4f} ms")

    def relayout(cell_order):
        return lambda: build_padded_layout(
            st.position, cfg.grid_shape, tiling, *st.velocity.unbind(-1),
            valid=st.valid, derive_valid=True, cell_order=cell_order)
    by_tile = [median_ms(torch, relayout(False), reps=5, warm=1)]
    by_cell = [median_ms(torch, relayout(True), reps=5, warm=1)
               for _ in range(2)]
    by_tile.append(median_ms(torch, relayout(False), reps=5, warm=1))
    log("7 ES 3D", f"resort (build_padded_layout, {rows} rows): rows by "
                   f"cell {np.mean(by_cell):.4f} ms (the shell's), by tile "
                   f"{np.mean(by_tile):.4f} ms; real rows in cell order "
                   f"after the resort")
    del args, e_grid, rho
    profile_window(torch, "7 ES 3D", f"{resort} steps + resort",
                   lambda: sim.step(resort))
    return {
        "name": "B5:es3d_substep", "route": "cuda",
        "source": "fusion_sim_torch/csrc/es3d_substep.cu",
        "replaces": "fusion_sim_tpu/ops/pallas_pic3d.py:213",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }, resorted


def phase8_em3d_main(torch, em, fe3, smi, kernel_modules):
    from fusion_sim_torch.examples import bench_3d as b3d
    from fusion_sim_torch.ops import node_table3d as nt
    from fusion_sim_torch.ops import yee3d as y3

    n, resort, windows = b3d.N, b3d.RESORT, 3
    t0 = time.perf_counter()
    sim = b3d.build_sim("em", "fused", n)
    cfg, tiling = sim.config, sim.tiling
    spill_capacity = sim.spill_capacity
    torch.cuda.synchronize()
    rows = sim.state.position.shape[0]
    log("8 EM 3D", f"set-up {time.perf_counter() - t0:.2f} s ({n} particles, "
                   f"128^3, {rows} layout rows, tile 8^3 block 512 margin 2, "
                   f"resort every {resort}, spill capacity {spill_capacity})")
    r0 = sorted_gauss_residual(torch, em, sim)
    t0 = time.perf_counter()
    sim.step(resort)
    torch.cuda.synchronize()
    log("8 EM 3D", f"warm window ({resort} steps + resort) "
                   f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    zero_counts((*kernel_modules, y3, nt))
    rates = run_windows(torch, sim, windows, resort)
    launches = fe3.LAUNCHES
    steps = windows * resort
    if launches != steps or y3.LAUNCHES != steps or nt.LAUNCHES != steps:
        raise AssertionError(f"B6 launches {launches}, Y1 launches "
                             f"{y3.LAUNCHES}, T1 launches {nt.LAUNCHES} != "
                             f"steps {steps}")
    y_launches, t_launches = y3.LAUNCHES, nt.LAUNCHES
    resorted = resort_launches(kernel_modules, windows, "8 EM 3D")
    st = sim.state
    check_em_state(torch, st, n)
    r1 = sorted_gauss_residual(torch, em, sim)
    if not r1 - r0 < 5e-3 * max(r0, 1.0):
        raise AssertionError(f"Gauss residual grew from {r0} to {r1}")
    rate = float(np.median(rates))
    en = sim.energies()
    log("8 EM 3D", f"{smi}: {steps} timed steps, windows "
                   f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, median "
                   f"{rate:.3f} steps/s = {rate * n:.4g} particle updates/s; "
                   f"B6 launches {launches}, bucket resort {resorted}; "
                   f"spill patched {st.spill}, "
                   f"dropped {st.spill_dropped} (capacity {spill_capacity}); "
                   f"Gauss residual {r0:.6g} -> {r1:.6g} over {st.step} "
                   f"steps; field energy {en['field']:.6g}, kinetic "
                   f"{en['kinetic']:.6g}; peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # kernel vs plain and bound, on the main path's own inputs
    table = nt.node_table_3d(st.e, st.b)
    plain_table = nt.node_table_3d_plain(st.e, st.b)
    torch.cuda.synchronize()
    if not torch.equal(table, plain_table):
        raise AssertionError("T1 differs from the plain node table")
    del plain_table
    args = em_substep_args(cfg, tiling, table, st)
    err, report = compare_fused(
        torch, "B6", fe3.fused_em3d_substep(*args),
        fe3.fused_em3d_substep_plain(*args), args[3], "J")
    k_ms = median_ms(torch, lambda: fe3.fused_em3d_substep(*args))
    p_ms = median_ms(torch, lambda: fe3.fused_em3d_substep_plain(*args),
                     reps=3, warm=1)
    b_ms, b_by, b_bytes = em3d_bound_ms(rows, n, cfg.grid_shape,
                                        tiling.block)
    log("8 EM 3D", f"em3d_substep on the main path's inputs ({rows} rows): "
                   f"{report}; kernel {k_ms:.4f} ms "
                   f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s effective), "
                   f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    c_ms = median_ms(torch, lambda: nt.node_table_3d_plain(st.e, st.b))
    t_ms = median_ms(torch, lambda: nt.node_table_3d(st.e, st.b))
    tb_ms, tb_by, tb_bytes = node_table_bound_ms(cfg.grid_shape)
    log("8 EM 3D", f"T1 node_table3d (128^3): the table equals the plain "
                   f"version's; kernel {t_ms:.4f} ms "
                   f"({tb_bytes / (t_ms * 1e-3) / 1e9:.1f} GB/s effective, "
                   f"{100 * tb_ms / t_ms:.1f}% of its bound), plain "
                   f"(center_fields) {c_ms:.4f} ms, bound {tb_ms:.4f} ms "
                   f"({tb_by})")
    # Y1 on the main path's fields and the J of its last step's deposit
    j = fe3.fused_em3d_substep(*args)[2]
    yee = (st.e, st.b, j, cfg.dt, cfg.cell_size, cfg.c, cfg.eps0)
    got, plain = y3.yee_update_3d(*yee), y3.yee_update_3d_plain(*yee)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
        raise AssertionError("Y1 differs from the plain Yee update")
    del got, plain
    y_ms = median_ms(torch, lambda: y3.yee_update_3d(*yee))
    yp_ms = median_ms(torch, lambda: y3.yee_update_3d_plain(*yee))
    yb_ms, yb_by, yb_bytes = yee_bound_ms(cfg.grid_shape)
    log("8 EM 3D", f"Y1 yee3d (128^3): E and B "
                   f"equal the plain version's; kernel {y_ms:.4f} ms "
                   f"({yb_bytes / (y_ms * 1e-3) / 1e9:.1f} GB/s effective, "
                   f"{100 * yb_ms / y_ms:.1f}% of its bound), plain "
                   f"{yp_ms:.4f} ms, bound {yb_ms:.4f} ms ({yb_by})")
    del args, table, j, yee
    profile_window(torch, "8 EM 3D", f"{resort} steps + resort",
                   lambda: sim.step(resort))
    y1 = {
        "name": "Y1:yee3d", "route": "cuda",
        "source": "fusion_sim_torch/csrc/yee3d.cu",
        "replaces": "none: the reference's yee_update is XLA",
        "launches": y_launches, "max_abs_err": 0.0, "ms": y_ms,
        "plain_ms": yp_ms, "bound_ms": yb_ms, "bound_by": yb_by,
        "library_ms": None,
    }
    t1 = {
        "name": "T1:node_table3d", "route": "cuda",
        "source": "fusion_sim_torch/csrc/node_table3d.cu",
        "replaces": "none: the reference's center_fields is XLA",
        "launches": t_launches, "max_abs_err": 0.0, "ms": t_ms,
        "plain_ms": c_ms, "bound_ms": tb_ms, "bound_by": tb_by,
        "library_ms": None,
    }
    return {
        "name": "B6:em3d_substep", "route": "cuda",
        "source": "fusion_sim_torch/csrc/em3d_substep.cu",
        "replaces": "fusion_sim_tpu/ops/pallas_em3d.py:253",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }, y1, t1, resorted


# -- 8b. the bucket resort on each resort cell's state ------------------------

# label, particles, grid, tile, block, margin, velocity components, drift in
# cells over a window (ES: 0.2 a step for 12 steps; EM: 0.01 for 6; ES 3D:
# 0.051 for 6; 2D3V: 0.04 for 12), rows by cell
RESORT_CELLS = (
    ("ES 2D 10M", 9_999_360, (512, 512), (32, 32), 1024, 6, 2, 2.4, False),
    ("EM 3D 30M", 29_997_056, (128,) * 3, (8, 8, 8), 512, 2, 3, 0.06, False),
    ("EM 3D 420M", 419_958_784, (128,) * 3, (8, 8, 8), 512, 2, 3, 0.06,
     False),
    ("ES 3D 30M by cell", 29_997_056, (128,) * 3, (8, 8, 8), 512, 2, 3,
     0.306, True),
    ("2D3V 10M by cell", 10_002_432, (512, 512), (32, 32), 1024, 6, 3, 0.48,
     True),
)


def resort_bound_ms(rows: int, fillers: int, dims: int, vdim: int,
                    n_keys: int, n_chunks: int, cell_order: bool = False):
    """(ms, 'bytes', bytes, floor_ms): the resort's least time.  A row is
    read once (position, velocity, valid) and written once (with tile_id,
    4 B, and valid, 1 B), a filler row is written, and the int32 count
    matrix is written, scanned (read and written) and read once.
    ``floor_ms`` is this design's floor: the count pass reads each row's
    position and valid again; by cell the cell pass reads the position a
    third time and reads and writes the row's words once more."""
    row = 4 * (dims + vdim)
    moved = (rows * ((row + 1) + (row + 5)) + fillers * (row + 5)
             + 4 * 4 * n_keys * (n_chunks + 1))
    ms, by = bound(moved, 0)
    extra = rows * (4 * dims + 1)
    if cell_order:
        extra += rows * (4 * dims + 2 * row)
    floor_ms, _ = bound(moved + extra, 0)
    return ms, by, moved, floor_ms


def kernel_device_ms(torch, fn, pattern: str, reps: int = 5):
    """Mean device ms a call of the kernels whose name holds ``pattern``,
    from a profiler over ``reps`` calls (None where it records no device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages() if pattern in e.key)
    return total / 1e3 / reps if total > 0 else None


def phase8b_resort(torch, smi, main_launches):
    """The bucket resort against the sort on each resort cell's state after
    a window; returns the kernel entries, whose launches are those counted
    on the cell's main path (``main_launches``, by label: phases 4, 6, 7
    and 8) or, where chip_smoke drives none, those of this phase."""
    from fusion_sim_torch.ops import tile_bucket as tb
    from fusion_sim_torch.ops.sorted_deposit import (
        Tiling2D, Tiling3D, build_padded_layout, build_padded_layout_plain)

    def bits(t):    # floats as their raw bits: NaN and -0.0 exactly
        return t.view(torch.int32) if t.is_floating_point() else t

    dev = torch.device("cuda")
    entries = []
    for label, n, shape, tile, block, margin, vdim, drift, cell_order \
            in RESORT_CELLS:
        dims = len(shape)
        tiling = (Tiling2D(*tile, block, margin=margin) if dims == 2
                  else Tiling3D(tile, block, margin=margin))
        n_tiles = math.prod(tiling.n_tiles(shape))
        gen = torch.Generator(device=dev).manual_seed(19)
        ext = torch.tensor(shape, dtype=torch.float32, device=dev)
        pos = torch.rand((n, dims), generator=gen, device=dev) * ext
        vel = torch.randn((n, vdim), generator=gen, device=dev)
        _, pos, vel, valid, _ = build_padded_layout(
            pos, shape, tiling, vel, derive_valid=True, cell_order=cell_order)
        pos = torch.remainder(pos + drift * vel[:, :dims], ext)
        rows = pos.shape[0]
        torch.cuda.synchronize()

        def layout(build):
            return lambda: build(pos, shape, tiling, vel, valid=valid,
                                 derive_valid=True, cell_order=cell_order)
        tb.LAUNCHES = 0
        got = layout(build_padded_layout)()
        if tb.LAUNCHES != 3 + cell_order:
            raise AssertionError(f"{label}: the resort did not launch the "
                                 f"bucket kernel" + (" and its cell pass"
                                                     if cell_order else ""))
        want = layout(build_padded_layout_plain)()
        err = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"{label}: the bucket resort differs "
                                     f"from the sort in output {i}")
            if a.is_floating_point():
                err = max(err, float(torch.sub(a, b).abs_()
                                     .nan_to_num_(0.0).max()))
        del got, want
        torch.cuda.empty_cache()
        k_ms = median_ms(torch, layout(build_padded_layout), reps=10)
        here = tb.LAUNCHES
        pass_ms = (kernel_device_ms(torch, layout(build_padded_layout),
                                    "cells_kernel") if cell_order else None)
        p_ms = median_ms(torch, layout(build_padded_layout_plain), reps=3,
                         warm=1)
        _, n_chunks = tb.chunking(rows, n_tiles + 1)
        b_ms, b_by, b_bytes, floor_ms = resort_bound_ms(
            rows, n_tiles * block, dims, vdim, n_tiles + 1, n_chunks,
            cell_order)
        rate = b_bytes / (k_ms * 1e-3) / 1e9
        launches = main_launches.get(label, here)
        by_cell = ""
        if cell_order:
            by_cell = (f"; the cell pass alone "
                       + ("not measured (no device time recorded)"
                          if pass_ms is None else f"{pass_ms:.4f} ms"))
        log("8b resort", f"{smi}: {label}, {rows} rows (drift {drift} "
                         f"cells): bit for bit against the sort (max abs "
                         f"err {err}); bucket kernel {k_ms:.4f} ms "
                         f"({rate:.1f} GB/s effective), sort {p_ms:.4f} ms, "
                         f"bound {b_ms:.4f} ms ({b_by}; the design's floor "
                         f"{floor_ms:.4f} ms){by_cell}; launches "
                         f"{here} here"
                         + (f", {launches} on the main path"
                            if label in main_launches else ""))
        entries.append({
            "name": f"tile_bucket:{label}", "route": "cuda",
            "source": "fusion_sim_torch/csrc/tile_bucket.cu",
            "replaces": "none (the reference resorts with lax.sort)",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
        del pos, vel, valid
        torch.cuda.empty_cache()
    return entries


# -- phase 3, the paths of this slice: X1 and small runs against the CPU ------

X1_DEPTHS = (24, 32, 48, 96, 128)
X1_EDGES = ((3, 1, 96, 8, 128), (2, 1, 20, 40, 196), (4, 5, 36, 136, 100))


def compare_x1(torch, cd, a, b, order, precision):
    """X1 against its plain version on the same inputs: every output within
    1e-5 ('highest', 3xTF32) or 1e-4 ('default', bf16 products exact, f32
    sums in another order) of sum |a||b|.  Returns (max_abs_err, worst
    error over its bound).  Launches made here are not part of a counted
    run."""
    got = cd.contraction_depth(a, b, order, precision)
    plain = cd.contraction_depth_plain(a, b, order, precision)
    scale = cd.contraction_depth_plain(a.abs(), b.abs(), order, "highest")
    torch.cuda.synchronize()
    tol = 1e-5 if precision == "highest" else 1e-4
    err = (got - plain).abs()
    if tuple(got.shape) != tuple(plain.shape) or not bool(
            (err <= tol * scale).all()):
        raise AssertionError(f"X1 {order} {precision} K={a.shape[-1]}: "
                             f"kernel vs plain beyond {tol} of sum|a||b| "
                             f"(worst {float((err / scale).max()):.3g})")
    return float(err.max()), float((err / scale).max())


def phase3_x1(torch, cd, dev):
    s, g, m, p = 8, 4, 96, 256
    for order in cd.ORDERS:
        for precision in cd.PRECISIONS:
            worst = []
            for k in X1_DEPTHS:
                gen = torch.Generator(device=dev).manual_seed(k)
                a_shape = (s, g, m, k) if order == "lhs_k_lanes" \
                    else (s, g, k, m)
                a = torch.randn(a_shape, generator=gen, device=dev)
                b = torch.randn((s, g, k, p), generator=gen, device=dev)
                worst.append(compare_x1(torch, cd, a, b, order,
                                        precision)[1])
            # the ring's edges: one stage only (G 1, K 8), K not a multiple
            # of the 16-deep stage, odd G, m off 16 rows, ragged p
            for es, eg, em_, ek, ep in X1_EDGES:
                gen = torch.Generator(device=dev).manual_seed(ek + eg)
                a_shape = (es, eg, em_, ek) if order == "lhs_k_lanes" \
                    else (es, eg, ek, em_)
                a = torch.randn(a_shape, generator=gen, device=dev)
                b = torch.randn((es, eg, ek, ep), generator=gen, device=dev)
                worst.append(compare_x1(torch, cd, a, b, order,
                                        precision)[1])
            log("3 kernels", f"contraction_depth {order} {precision} "
                             f"(S {s}, G {g}, m {m}, p {p}), K "
                             f"{'/'.join(map(str, X1_DEPTHS))}, then "
                             f"(S, G, m, K, p) {X1_EDGES}: worst error "
                             f"{'/'.join(f'{w:.2g}' for w in worst)} of "
                             f"sum|a||b| (tol "
                             f"{1e-5 if precision == 'highest' else 1e-4:g})")


def card_vs_cpu(torch, label, cpu, from_state, names, steps, n_real,
                tol=1e-4, need_spill=False):
    """A small run on the card against the same run on the CPU from one
    carried state: no drops (and, with ``need_spill``, some rows patched),
    ``names`` within ``tol`` of their scale, energies within 1e-4, the
    valid rows' sorted positions within 1e-3 of a cell; with repair, rows
    relocated on both and ``unplaced`` shown."""
    blob = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in cpu.state._asdict().items() if v is not None}
    gpu = from_state(blob)
    start = cpu.state.valid.clone()
    cpu.step(steps)
    gpu.step(steps)
    if gpu.state.spill_dropped or cpu.state.spill_dropped:
        raise AssertionError(f"{label} dropped rows")
    if need_spill and not min(gpu.state.spill, cpu.state.spill) > 0:
        raise AssertionError(f"{label}: no row was patched")
    errs = {}
    for name in names:
        want = getattr(cpu.state, name)
        errs[name] = float((getattr(gpu.state, name).cpu() - want).abs()
                           .max()) / float(want.abs().max())
        if errs[name] > tol:
            raise AssertionError(f"{label} {name}: card vs CPU {errs[name]} "
                                 f"relative")
    e_c, e_g = cpu.energies(), gpu.energies()
    for key in ("kinetic", "field"):
        if not math.isclose(e_g[key], e_c[key], rel_tol=1e-4):
            raise AssertionError(f"{label} {key}: card {e_g[key]} vs CPU "
                                 f"{e_c[key]}")
    grid = np.asarray(cpu.config.grid_shape, np.float32)
    pc = np.mod(cpu.state.position[cpu.state.valid].numpy(), grid)
    pg = np.mod(gpu.state.position[gpu.state.valid].cpu().numpy(), grid)
    dmax = max(float(np.abs(np.sort(pc[:, a]) - np.sort(pg[:, a])).max())
               for a in range(pc.shape[1]))
    if pg.shape[0] != n_real or pc.shape[0] != n_real or dmax > 1e-3:
        raise AssertionError(f"{label}: {pg.shape[0]} / {pc.shape[0]} valid "
                             f"rows, positions differ by {dmax}")
    extra = ""
    if cpu.state.unplaced is not None:
        moved = [int((s.valid.cpu() != start).sum())
                 for s in (gpu.state, cpu.state)]
        if min(moved) == 0:
            raise AssertionError(f"{label}: repair relocated no row")
        differ = int((gpu.state.valid.cpu() != cpu.state.valid).sum())
        extra = (f", rows moved card {moved[0]} / CPU {moved[1]}, validity "
                 f"differs on {differ} rows, unplaced card "
                 f"{int(gpu.state.unplaced)} / CPU {int(cpu.state.unplaced)}")
    log("3 kernels", f"{label} ({n_real} particles, {steps} steps, spill "
                     f"card {gpu.state.spill} / CPU {cpu.state.spill}): card "
                     f"vs CPU " + ", ".join(f"{k} within {v:.3g}"
                                            for k, v in errs.items())
                     + f" of their scale, kinetic {e_g['kinetic']:.9g} / "
                     f"{e_c['kinetic']:.9g}, sorted positions within "
                     f"{dmax:.3g}" + extra)


def phase3_slice(torch, es, em, pm, ps, an, sc, Tiling2D, Tiling3D, dev):
    """ES xla, ES/EM/pusher repair and the fast path: small runs on the
    card against the CPU."""
    from fusion_sim_torch.bench import es_config
    from fusion_sim_torch.examples.bench_3d import em_config as em3d_config
    from fusion_sim_torch.examples.bench_3d import es_config as es3d_config
    from fusion_sim_torch.examples.bench_em_fused import em_config
    from fusion_sim_torch.ops.repair import init_free_list

    n2, cells = 16384, 64
    rng = np.random.default_rng(51)
    pos = (rng.random((n2, 2)) * cells).astype(np.float32)
    vel = (0.3 * rng.standard_normal((n2, 2))).astype(np.float32)
    vel[:, 0] += 1.5              # ~0.1 cells a step: tiles churn
    cfg = es_config(n2, cells)
    for label, kw, steps in (
            ("small ES run (xla)", dict(backend="xla", resort_every=4,
                                        spill_tiers=(64, 512)), 10),
            ("small ES repair run (pallas, eager 1)",
             dict(backend="pallas", resort_every=10 ** 6, repair=True,
                  repair_eager=1), 10)):
        kw = dict(kw, tiling=Tiling2D(16, 16, 256, margin=2),
                  spill_capacity=4096, check_spill=False)
        card_vs_cpu(torch, label, es.SortedElectrostaticPIC(
            cfg, pos, vel, device="cpu", **kw),
            lambda blob, kw=kw: es.SortedElectrostaticPIC.from_state(
                cfg, blob, device="cuda", **kw), ("rho",) if kw[
                "backend"] == "pallas" else (), steps, n2)
    n3, cells3 = 8192, 16
    pos3 = (rng.random((n3, 3)) * cells3).astype(np.float32)
    vel3 = (0.3 * rng.standard_normal((n3, 3))).astype(np.float32)
    vel3[:, 0] += 1.5
    cfg3 = es3d_config(n3, cells3)
    kw = dict(tiling=Tiling3D((8, 8, 8), 128, margin=2), backend="pallas",
              resort_every=10 ** 6, repair=True, repair_eager=1,
              spill_capacity=4096, check_spill=False)
    card_vs_cpu(torch, "small 3D ES repair run (pallas, eager 1)",
                es.SortedElectrostaticPIC(cfg3, pos3, vel3, device="cpu",
                                          **kw),
                lambda blob: es.SortedElectrostaticPIC.from_state(
                    cfg3, blob, device="cuda", **kw), ("rho",), 8, n3)

    vel_em = (0.3 * rng.standard_normal((n2, 3))).astype(np.float32)
    vel_em[:, 0] += 2.5           # 0.5 cells a step against margin 2
    kw = dict(tiling=Tiling2D(16, 16, 256, margin=2), resort_every=10 ** 6,
              spill_capacity=4096, check_spill=False, gather_backend="fused",
              repair=True)
    cfg_em = em_config(cells)
    card_vs_cpu(torch, "small EM repair run (fused)",
                em.SortedElectromagneticPIC(cfg_em, pos, vel_em,
                                            device="cpu", **kw),
                lambda blob: em.SortedElectromagneticPIC.from_state(
                    cfg_em, blob, device="cuda", **kw), ("e", "b"), 10, n2)
    vel3_em = (0.3 * rng.standard_normal((n3, 3))).astype(np.float32)
    vel3_em[:, 0] += 2.5
    kw = dict(kw, tiling=Tiling3D((8, 8, 8), 128, margin=2), repair_eager=1)
    cfg3_em = em3d_config(cells3)
    card_vs_cpu(torch, "small 3D EM repair run (fused, eager 1)",
                em.SortedElectromagneticPIC(cfg3_em, pos3, vel3_em,
                                            device="cpu", **kw),
                lambda blob: em.SortedElectromagneticPIC.from_state(
                    cfg3_em, blob, device="cuda", **kw), ("e", "b"), 8, n3)

    # the fused pusher with repair: one carried state and fields, the same
    # uniforms, no resort; relocation is integer work on bit-identical
    # positions (B2 matches its plain version bit for bit), so the layouts
    # must agree exactly
    small = dict(nr=64, nz=128)
    cpu = sc.build_default_sim(32, device="cpu", **small)
    n = cpu.spec.n_total
    r = np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    cpu.set({"position": np.stack([r * np.cos(th), r * np.sin(th),
                                   2 * rng.random(n)], -1),
             "velocity": 0.02 * rng.standard_normal((n, 3))})
    gpu = pm.CylindricalParticlePusher(dict(sc.DEFAULT_SPEC, nparticles=32,
                                            **small), device="cuda")
    gpu.set_state(cpu.get_state())
    tiling = Tiling2D(8, 16, 128, 3)
    step = ps.make_sorted_step_fn(cpu.spec, tiling, 4096, "fused",
                                  repair=True)
    n_tiles = math.prod(tiling.n_tiles((64, 128)))
    states = []
    for sim in (cpu, gpu):
        st = ps.to_sorted_state(sim.state, sim.spec, tiling, reserve=True)
        fidx, fcnt = init_free_list(st.tile_id, st.valid, n_tiles,
                                    tiling.block, 64)
        states.append(st._replace(free_idx=fidx, free_cnt=fcnt,
                                  unplaced=torch.zeros(
                                      (), dtype=torch.int64,
                                      device=st.position.device)))
    start = states[0].valid.clone()
    gen = torch.Generator().manual_seed(17)
    for _ in range(6):
        rands = [torch.rand((states[0].position.shape[0], 4), generator=gen)
                 for _ in range(2)]
        states = [step(cpu.fields, states[0], rands),
                  step(gpu.fields, states[1], [x.to(dev) for x in rands])]
    st_c, st_g = states
    for name in ("valid", "alive", "free_idx", "free_cnt", "unplaced"):
        if not torch.equal(getattr(st_c, name), getattr(st_g, name).cpu()):
            raise AssertionError(f"small pusher repair run: {name} differs "
                                 f"between card and CPU")
    counts = [(getattr(st_c, k), getattr(st_g, k))
              for k in ("spill", "dropped", "dropped_over")]
    if any(a != b for a, b in counts):
        raise AssertionError(f"small pusher repair run counters {counts}")
    errs = [float((getattr(st_g, k).cpu() - getattr(st_c, k)).abs().max())
            / float(getattr(st_c, k).abs().max())
            for k in ("position", "velocity")]
    moved = int((st_c.valid != start).sum())
    if max(errs) > 1e-6 or moved == 0:
        raise AssertionError(f"small pusher repair run: rows differ by "
                             f"{errs} of their scale, {moved} rows moved")
    log("3 kernels", f"small pusher repair run (fused, {n} protons, 64 x "
                     f"128, 6 steps, spill {st_g.spill}, {moved} rows "
                     f"relocated, unplaced {int(st_g.unplaced)}): card vs "
                     f"CPU validity, alive, free stacks and counters equal, "
                     f"positions within {errs[0]:.3g}, velocities within "
                     f"{errs[1]:.3g} of their scale")

    # the fast path: one run on the same uniforms.  The rotation is taken
    # in the (r, theta) frame of x / r, so near the axis a 1e-7 relative
    # perturbation of a position grows to ~1e-5 of a velocity in 6
    # substeps (measured on the CPU); rows start off the axis and are held
    # at 1e-4 of their scale (CUDA's rsqrt and log differ from the CPU's
    # by ulps)
    spec = pm.PusherSpec(**dict(sc.DEFAULT_SPEC, nparticles=64))
    scen = an.default_scenario()
    n = spec.n_total
    r = 0.05 + 0.25 * rng.random(n)
    r[::20] = 1.05                # outside the sink box: they respawn
    th = 2 * np.pi * rng.random(n)
    pos_f = np.stack([r * np.cos(th), r * np.sin(th),
                      0.3 + 0.4 * rng.random(n)], -1).astype(np.float32)
    vel_f = (0.002 * rng.standard_normal((n, 3))).astype(np.float32)
    states = [an.FastState(torch.tensor(pos_f, device=d),
                           torch.tensor(vel_f, device=d),
                           torch.ones(n, device=d)) for d in ("cpu", dev)]
    gen = torch.Generator().manual_seed(18)
    for _ in range(6):
        rand = torch.rand((n, 4), generator=gen)
        states = [an._substep(spec, scen, states[0], rand),
                  an._substep(spec, scen, states[1], rand.to(dev))]
    st_c, st_g = states
    if not torch.equal(st_c.alive, st_g.alive.cpu()):
        raise AssertionError("fast path: alive differs between card and CPU")
    errs = []
    for name in ("position", "velocity"):
        want, got = getattr(st_c, name), getattr(st_g, name).cpu()
        scale = want.abs().amax(dim=1, keepdim=True)
        errs.append(float(((got - want).abs() / scale).max()))
    if max(errs) > 1e-4:
        raise AssertionError(f"fast path: card vs CPU rows differ by {errs} "
                             f"of their scale")
    log("3 kernels", f"fast path ({n} protons, default scenario, 6 "
                     f"substeps, {n // 20} rows respawned): card vs CPU "
                     f"alive equal, positions within {errs[0]:.3g}, "
                     f"velocities within {errs[1]:.3g} of each row's scale "
                     f"(tol 1e-4)")


# -- phase 3, this slice's modules: the spindle BEM and weighted Jacobi ----------

def phase3_a1(torch, sp, solvers, dev):
    """The spindle-cusp field at n_power 2 on a 100 x 200 grid and weighted
    Jacobi on a diagonally dominant 1024 x 1024 system, each on the card
    against the same call on the CPU."""
    # the element fields are f32 closed forms whose self-element entries
    # (point and loop ~1e-4 m apart) amplify an ulp through log(1 - m);
    # the direct solve (condition number 92) carries that into the
    # currents, measured at ~5e-6 of max|x| between two CPU roundings of
    # the same function: the field is held at 1e-4 of max|B|
    kw = dict(radius=1.0, height=2.0, nr=100, nz=200, coil_current=1e6,
              n_power=2)
    t0 = time.perf_counter()
    card = sp.spindle_cusp_field(**kw, device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu = sp.spindle_cusp_field(**kw, device="cpu")
    g_card = sp.build_geometry(1.0, 2.0, 64, device=dev)
    g_cpu = sp.build_geometry(1.0, 2.0, 64, device="cpu")
    a_card = sp._bem_matrix(g_card, 2.0).cpu()
    a_cpu = sp._bem_matrix(g_cpu, 2.0)
    a_scale = float(a_cpu.abs().max())
    a_err = (a_card - a_cpu).abs() / a_scale
    diag = torch.eye(64, dtype=torch.bool)
    scale = float(cpu.abs().max())
    err = float((card.cpu() - cpu).abs().max()) / scale
    if tuple(card.shape) != (100, 200, 3) or not err < 1e-4:
        raise AssertionError(f"spindle_cusp_field card vs CPU: "
                             f"{tuple(card.shape)}, {err:.3g} of max|B| "
                             f"(tol 1e-4)")
    log("3 kernels", f"spindle_cusp_field (n_power 2, 64 loops, 100 x 200, "
                     f"{t_card * 1e3:.1f} ms on the card): card vs CPU "
                     f"{err:.3g} of max|B| (tol 1e-4); BEM matrix off the "
                     f"diagonal {float(a_err[~diag].max()):.3g}, on it "
                     f"{float(a_err[diag].max()):.3g} of max|A|")

    # weighted Jacobi: 12 checks to tolerance 3e-5 on the CPU; the last two
    # diffs sit 8 and 32 ulp-steps of diff (2n ulp(max|x|) / (|sum x1| +
    # |sum x2|)) from the tolerance, so sums in another order keep the stop
    rng = np.random.default_rng(12)
    n = 1024
    a = (rng.random((n, n)) * 0.2).astype(np.float32)
    a += np.diag(2 * np.abs(a).sum(axis=1) + 1.0).astype(np.float32)
    b = (rng.standard_normal(n) + 1.0).astype(np.float32)
    opts = dict(tolerance=3e-5, max_iterations=200, omega=0.9)
    out = solvers.weighted_jacobi(a, b, **opts, device=dev)
    ref = solvers.weighted_jacobi(a, b, **opts, device="cpu")
    x_ref = ref.result.numpy()
    x_err = float(np.abs(out.result.cpu().numpy() - x_ref).max()
                  / np.abs(x_ref).max())
    step = n * float(np.spacing(np.float32(np.abs(x_ref).max()))) / abs(
        float(x_ref.sum()))
    d_err = abs(float(out.diff) - float(ref.diff))
    if (out.iterations != ref.iterations or not x_err < 1e-5
            or not d_err <= 1e-3 * float(ref.diff) + 4 * step
            or not abs(float(out.correlation) - float(ref.correlation))
            < 1e-5):
        raise AssertionError(
            f"weighted_jacobi card vs CPU: iterations {out.iterations} / "
            f"{ref.iterations}, result {x_err:.3g} of max|x| (tol 1e-5), "
            f"diff {float(out.diff):.6g} / {float(ref.diff):.6g}, "
            f"correlation {float(out.correlation):.7g} / "
            f"{float(ref.correlation):.7g}")
    log("3 kernels", f"weighted_jacobi (1024 x 1024, omega 0.9, tol 3e-5): "
                     f"{out.iterations} checks on both; result within "
                     f"{x_err:.3g} of max|x| (tol 1e-5), diff "
                     f"{float(out.diff):.6g} / {float(ref.diff):.6g} (tol "
                     f"1e-3 of it + 4 ulp-steps), correlation within "
                     f"{abs(float(out.correlation) - float(ref.correlation)):.2g}"
                     f" (tol 1e-5)")


# -- 12. the viewer: the reference app's live mode on the card --------------------

class ViewerClient:
    """JSON over HTTP to the viewer serving in this process."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def post(self, path: str, obj=None, code: int = 200) -> dict:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            self.base + path, data=json.dumps(obj or {}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                got, body = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            got, body = e.code, json.loads(e.read())
        if got != code or (code == 200 and not body.get("ok")):
            raise AssertionError(f"POST {path}: HTTP {got} {body} "
                                 f"(expected {code})")
        return body

    def get(self, path: str) -> bytes:
        import urllib.request
        with urllib.request.urlopen(self.base + path, timeout=600) as r:
            return r.read()

    def state(self) -> dict:
        return json.loads(self.get("/api/state"))


def check_frame(png, data: bytes, shape) -> None:
    img = png.decode_png(data)
    if img.shape != shape:
        raise AssertionError(f"frame {img.shape}, expected {shape}")


def check_diagnostics(values: dict, label: str) -> None:
    bad = {k: v for k, v in values.items()
           if k not in ("step", "time") and not math.isfinite(v)}
    if not values or bad:
        raise AssertionError(f"{label} diagnostics not finite: {bad or 'none'}")


def spindle_timing(torch, sp, smi, dev):
    """The BEM solve at the viewer's width (n_power 3 = 256 loops, 400 x
    800): ms to build the matrix, solve it and sum the grid field, and the
    cancellation of the normal field at the collocation points."""
    radius, height, current, n = 1.0, 2.0, 1e6, 256
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    geom = sp.build_geometry(radius, height, n, device=dev)
    a = sp._bem_matrix(geom, height)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    geom, cur, _ = sp.solve_surface_currents(radius, height, current,
                                             n_loops=n, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    field = sp.grid_field(geom, cur, radius, height, 400, 800)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    inc = sp.coil_field(geom.points[:, 0], geom.points[:, 1], radius, height,
                        current)
    bn_inc = sp._normal_component(geom.normals, inc).double()
    total = bn_inc + a.double() @ cur.double()
    ratio = float(total.abs().max() / bn_inc.abs().max())
    if not ratio < 1e-3 or not bool(torch.isfinite(field).all()):
        raise AssertionError(f"spindle BEM at n_power 3: residual normal "
                             f"field {ratio:.3g} of the incident (bar 1e-3)")
    log("12 viewer", f"{smi}: spindle BEM (n_power 3, 256 loops, 400 x "
                     f"800): matrix {(t1 - t0) * 1e3:.2f} ms, solve (matrix "
                     f"again + host float64 solve) {(t2 - t1) * 1e3:.2f} ms, "
                     f"grid field {(t3 - t2) * 1e3:.2f} ms; residual normal "
                     f"field at the collocation points {ratio:.3g} of the "
                     f"incident (bar 1e-3)")


def phase12_viewer(torch, sp, fpu, smi, kernel_modules, dev="cuda",
                   nparticles=4100):
    """The port's viewer served in this process on 127.0.0.1:0 and driven
    over HTTP at phase 5's width (16,810,000 protons)."""
    import threading

    from fusion_sim_torch import scenarios as sc
    from fusion_sim_torch.utils import png
    from fusion_sim_torch.viewer import server as vs

    spindle_timing(torch, sp, smi, dev)
    srv = vs.serve("127.0.0.1", 0, device=dev)
    service = srv.service
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    http = ViewerClient(srv.server_address[1])
    try:
        spec = dict(sc.DEFAULT_SPEC, nparticles=nparticles, scenario="default")
        n = nparticles ** 2
        t0 = time.perf_counter()
        http.post("/api/config", spec)
        t1 = time.perf_counter()
        http.post("/api/add_spindle_cusp_plasma_field",
                  {"coil_current": 1e6, "n_power": 3})
        t2 = time.perf_counter()
        refused = http.post("/api/enable_fast_path", {}, code=400)
        if "analytic sources" not in refused["error"]:
            raise AssertionError(f"fast path refusal: {refused}")
        http.post("/api/enable_sorted_path", {
            "backend": "fused", "resort_every": 10, "spill_capacity": 16384})
        http.post("/api/precalc")
        t3 = time.perf_counter()
        log("12 viewer", f"POST /api/config (default scenario, {n} protons, "
                         f"400 x 800) {t1 - t0:.2f} s; add_spindle_cusp_"
                         f"plasma_field (n_power 3) {(t2 - t1) * 1e3:.1f} "
                         f"ms; enable_fast_path refused (400: "
                         f"{refused['error']}); enable_sorted_path (fused, "
                         f"resort 10, spill 16384) + precalc "
                         f"{t3 - t2:.2f} s")
        http.post("/api/step", {"n": 20})           # warm: the first window
        zero_counts(kernel_modules)
        t0 = time.perf_counter()
        steps = http.post("/api/step", {"n": 20})["steps"]
        dt = time.perf_counter() - t0
        launches = fpu.LAUNCHES
        others = {m.__name__.split(".")[-1]: m.LAUNCHES
                  for m in kernel_modules if m is not fpu and m.LAUNCHES}
        resorted = others.pop("tile_bucket", 0)
        if steps != 40 or launches != 40 or others or resorted % 3:
            raise AssertionError(f"/api/step: steps {steps}, B2 launches "
                                 f"{launches} (expected 2 x 20), other "
                                 f"kernels {others}, bucket resort "
                                 f"{resorted} (3 a resort)")
        log("12 viewer", f"{smi}: POST /api/step n=20 (with its render, "
                         f"PNG and diagnostics sample) {dt:.3f} s = "
                         f"{20 / dt:.3f} steps/s = {2 * n * 20 / dt:.4g} "
                         f"pushes/s; B2 launches {launches} (2 a step), "
                         f"bucket resort {resorted}")

        zero_counts(kernel_modules)
        s0 = http.state()["steps"]
        http.post("/api/start")
        fps_seen, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < 3.5:
            time.sleep(0.25)
            st = http.state()
            if "error" in st:
                raise AssertionError(f"run thread: {st['error']}")
            if st["fps"] > 0:
                fps_seen.append(st["fps"])
        http.post("/api/stop")
        st = http.state()
        ran = st["steps"] - s0
        launches = fpu.LAUNCHES
        if not fps_seen or st["running"] or st["fps"] != 0.0 or ran <= 0 \
                or launches != 2 * ran:
            raise AssertionError(f"run/stop: fps seen {fps_seen}, after "
                                 f"stop running {st['running']} fps "
                                 f"{st['fps']}, {ran} steps, B2 launches "
                                 f"{launches}")
        fps = fps_seen[-1]
        log("12 viewer", f"{smi}: running ~3.5 s: {ran} steps, fps "
                         f"{', '.join(f'{f:.3f}' for f in fps_seen)} (last "
                         f"1 s window {fps:.3f} fps = {2 * n * fps:.4g} "
                         f"pushes/s, a step + render + PNG a frame); B2 "
                         f"launches {launches}; after stop fps "
                         f"{st['fps']}, running {st['running']}")

        check_diagnostics(st["diagnostics"], "/api/state")
        with service.lock:
            check_pusher_state(torch, service.sim.sim._sorted_state, n)
        data = http.get("/frame.png")
        check_frame(png, data, (800, 400, 3))
        series = json.loads(http.get("/api/diagnostics"))["series"]
        for sample in series:
            check_diagnostics(sample, f"series step {sample['step']}")
        since = json.loads(http.get(f"/api/diagnostics?since={s0}"))["series"]
        if not series or any(x["step"] <= s0 for x in since):
            raise AssertionError(f"diagnostics series: {len(series)} "
                                 f"samples, since={s0} gave {since[:1]}")
        page = http.get("/")
        encoder = ("native (native/libfspng.so)" if png.native_available()
                   else "pure Python (zlib, filter 0)")
        times = []
        with service.lock:
            adapter = service.sim
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rgb = adapter.render()
                t1 = time.perf_counter()
                png.encode_png(rgb)
                times.append(((t1 - t0) * 1e3,
                              (time.perf_counter() - t1) * 1e3))
            render_ms, encode_ms = np.median(np.array(times), axis=0)

            def frames():
                for _ in range(5):
                    adapter.step()
                    png.encode_png(adapter.render())

            profile_window(torch, "12 viewer", "5 frames: step + render + "
                           "PNG", frames)
        log("12 viewer", f"no row dropped, {n} valid rows, diagnostics "
                         f"finite ({len(series)} samples, {len(since)} since "
                         f"step {s0}); /frame.png {len(data)} bytes decodes "
                         f"to 800 x 400 RGB; page {len(page)} bytes; render "
                         f"+ PNG encode {render_ms + encode_ms:.2f} ms "
                         f"(render: density, frame and host copy "
                         f"{render_ms:.2f} ms, encode {encode_ms:.2f} ms; "
                         f"medians of 5; {encoder} encoder)")

        for cfg, shape, label in (
                ({"model": "es", "scenario": "two_stream"}, (200, 400, 3),
                 "ES two_stream (100,000 particles, 512 cells)"),
                ({"model": "em", "scenario": "weibel"}, (128, 128, 3),
                 "EM weibel (500,000 particles, 128^2)")):
            t0 = time.perf_counter()
            http.post("/api/config", cfg)
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            steps = http.post("/api/step", {"n": 5})["steps"]
            t2 = time.perf_counter()
            st = http.state()
            check_diagnostics(st["diagnostics"], label)
            check_frame(png, http.get("/frame.png"), shape)
            if steps != 5 or st["model"] != cfg["model"]:
                raise AssertionError(f"{label}: steps {steps}, model "
                                     f"{st['model']}")
            log("12 viewer", f"{label}: config {t1 - t0:.2f} s, 5 steps "
                             f"with a frame {t2 - t1:.3f} s; frame "
                             f"{shape[0]} x {shape[1]} RGB, diagnostics "
                             f"{json.dumps({k: round(v, 8) for k, v in st['diagnostics'].items()})}")
    finally:
        service.stop()
        srv.shutdown()
        thread.join(timeout=60)
        srv.server_close()


# -- 9. X1: the contraction-depth experiment at full size -----------------------

def x1_bound_ms(s, g, m, k, p, precision):
    """Least time for one X1 call: A, B read once and o written once, or
    2 s g m k p operations at the tensor cores' rate (bf16 for 'default',
    a third of TF32's for 3xTF32 'highest')."""
    bytes_moved = 4 * (s * g * (m * k + k * p) + s * p)
    flops = 2 * s * g * m * k * p
    peak = (BF16_FLOPS_PER_S if precision == "default"
            else TF32_FLOPS_PER_S / 3)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def x1_library(torch, a, b, order, precision):
    """One PyTorch call computing the same function (never used by the
    port): torch.matmul materialises (S, G, m, p), then the sums; f32 with
    TF32 off for 'highest', on bf16 copies for 'default'."""
    if order == "lhs_k_sublanes":
        a = a.transpose(-1, -2)
    s, g, m, _ = a.shape
    p = b.shape[-1]
    if precision == "default":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    need = s * g * m * p * a.element_size()
    free, _ = torch.cuda.mem_get_info()
    if free < 2 * need:
        raise AssertionError(f"the library call needs {need / 2**30:.2f} GiB "
                             f"for its (S, G, m, p) product; "
                             f"{free / 2**30:.2f} GiB free")
    return lambda: torch.matmul(a, b).sum(-2, dtype=torch.float32).sum(1)


def phase9_x1(torch, cd, mx, smi, kernel_modules):
    s, g, m, p = 305, 32, 96, 1024
    rows = s * g * p
    launches, headline = 0, None
    log("9 X1", f"{smi}: S {s}, G {g}, m {m}, p {p} (~{rows / 1e6:.1f}M "
                f"rows), K padded to 16 (bf16) / 8 (TF32)")
    for order in cd.ORDERS:
        for precision in cd.PRECISIONS:
            for k in X1_DEPTHS:
                fn, a, b = mx.make_bench(m, k, p, g, s, order, precision)
                torch.cuda.synchronize()
                zero_counts(kernel_modules)
                out = fn(a, b)
                torch.cuda.synchronize()
                if cd.LAUNCHES != 1:
                    raise AssertionError(f"X1 launches {cd.LAUNCHES} != 1")
                launches += 1
                if tuple(out.shape) != (s, 1, p) or not bool(
                        torch.isfinite(out).all()):
                    raise AssertionError(f"X1 output {tuple(out.shape)} not "
                                         f"finite/({s}, 1, {p})")
                err, worst = compare_x1(torch, cd, a, b, order, precision)
                k_ms = median_ms(torch, lambda: fn(a, b))
                p_ms = median_ms(torch, lambda: cd.contraction_depth_plain(
                    a, b, order, precision), reps=5, warm=1)
                lib = x1_library(torch, a, b, order, precision)
                l_ms = median_ms(torch, lib, reps=5, warm=1)
                del lib
                b_ms, b_by = x1_bound_ms(s, g, m, k, p, precision)
                log("9 X1", f"{order:16s} {precision:8s} K={k:3d} (depth "
                            f"{cd.padded_depth(k, precision):3d}): "
                            f"{k_ms:8.4f} ms ({rows / (k_ms * 1e-3) / 1e9:.2f}"
                            f"G rows/s), bound {b_ms:.4f} ms ({b_by}), "
                            f"{100 * b_ms / k_ms:.1f}% of bound; plain "
                            f"{p_ms:.4f} ms, library {l_ms:.4f} ms; vs plain "
                            f"max|d| {err:.3g} ({worst:.2g} of sum|a||b|)")
                if (order, precision, k) == ("lhs_k_lanes", "highest", 128):
                    headline = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=l_ms)
                del fn, a, b, out
                torch.cuda.empty_cache()
    return {
        "name": "X1:contraction_depth (lhs_k_lanes, highest, K=128)",
        "route": "cuda",
        "source": "fusion_sim_torch/csrc/contraction_depth.cu",
        "replaces": "examples/mxu_experiment.py:36",
        "launches": launches, "max_abs_err": headline["err"],
        "ms": headline["ms"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        "library_ms": headline["library_ms"],
    }


# -- 10. the analytic fast path (bench.py's headline) --------------------------

def phase10_fast(torch, smi):
    from fusion_sim_torch import bench as pb

    t0 = time.perf_counter()
    sim = pb.build_sim(1024)                       # 1,048,576 protons
    sim.enable_fast_path()
    n = sim.spec.n_total
    batch = 50
    sim.step(batch)
    torch.cuda.synchronize()
    log("10 fast", f"set-up and warm batch ({batch} steps) "
                   f"{time.perf_counter() - t0:.2f} s ({n} protons, 400 x "
                   f"800, dt 2e-9)")
    rates = []
    t_all = time.perf_counter()
    for _ in range(4):
        t0 = time.perf_counter()
        sim.step(batch)
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
    overall = 4 * batch / (time.perf_counter() - t_all)
    st = sim.state
    for name in ("position", "velocity", "alive"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"fast path state.{name} is not finite")
    alive = float(st.alive.mean())
    if not 0.0 < alive <= 1.0:
        raise AssertionError(f"alive fraction {alive}")
    scen = sim._fast_scenario
    fresh = st.alive == 0
    p = st.position[fresh]
    r = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2) * sim.spec.radius
    z = p[:, 2] * sim.spec.height
    r_lo, r_hi, z_lo, z_hi = scen.source_box
    eps = 1e-5
    if not bool(((r <= r_hi + eps) & (z >= z_lo - eps) & (z <= z_hi + eps))
                .all()):
        raise AssertionError("respawned rows outside the source box")
    rate = float(np.median(rates))
    log("10 fast", f"{smi}: 4 timed batches of {batch} steps, "
                   f"{', '.join(f'{x:.3f}' for x in rates)} steps/s, median "
                   f"{rate:.3f} steps/s = {2 * n * rate:.4g} pushes/s "
                   f"(bench.py's measure over the 4 batches: "
                   f"{2 * n * overall:.4g} pushes/s); alive fraction "
                   f"{alive:.6f}, {int(fresh.sum())} rows respawned in the "
                   f"last substep, all inside the source box")
    n_ops = profile_window(torch, "10 fast", f"{batch} steps",
                           lambda: sim.step(batch))
    if n_ops:
        log("10 fast", f"{n_ops / (2 * batch):.1f} device ops a substep")

    # the bench's drift bar: 256 protons, no sinks, 10k substeps
    t0 = time.perf_counter()
    drift = pb.bench_energy_drift_parity()
    worst = drift["value"]
    if drift["absorbed"] != 0 or not worst < 1e-3:
        raise AssertionError(f"drift {worst} (bar 1e-3), {drift['absorbed']}"
                             f" absorbed")
    log("10 fast", f"drift check (256 protons, mirror coils, no sinks, "
                   f"10,000 substeps, {time.perf_counter() - t0:.1f} s): max "
                   f"per-particle |dv|/v {worst:.3g} (bar 1e-3)")


# -- 11. the EM repair rung (kernel B4) ------------------------------------------

def phase11_em_repair(torch, em, fe, smi, kernel_modules, resort_rate):
    from fusion_sim_torch.examples import bench_em_fused as bem

    n = bem.N
    steps = 12
    t0 = time.perf_counter()
    # bench_em_fused.py --tile 16 --margin 7 --repair
    sim = bem.build_sim(n, tile=16, margin=7, backend="fused", repair=True)
    torch.cuda.synchronize()
    rows = sim.state.position.shape[0]
    log("11 EM repair", f"set-up {time.perf_counter() - t0:.2f} s ({n} "
                        f"particles, 512^2, {rows} layout rows, tile 16 "
                        f"margin 7, repair, resort 1e9, spill capacity "
                        f"16384)")
    r0 = sorted_gauss_residual(torch, em, sim)
    t0 = time.perf_counter()
    sim.step(steps)
    torch.cuda.synchronize()
    log("11 EM repair", f"warm window ({steps} steps) "
                        f"{time.perf_counter() - t0:.3f} s")
    zero_counts(kernel_modules)
    rates = run_windows(torch, sim, 2, steps)
    launches = fe.LAUNCHES
    if launches != 2 * steps:
        raise AssertionError(f"B4 launches {launches} != {2 * steps} steps")
    st = sim.state
    check_em_state(torch, st, n)
    r1 = sorted_gauss_residual(torch, em, sim)
    if not r1 - r0 < 5e-3 * max(r0, 1.0):
        raise AssertionError(f"Gauss residual grew from {r0} to {r1}")
    rate = float(np.median(rates))
    log("11 EM repair", f"{smi}: {2 * steps} timed steps, windows "
                        f"{', '.join(f'{x:.3f}' for x in rates)} steps/s, "
                        f"median {rate:.3f} steps/s = {rate * n:.4g} "
                        f"particle updates/s (phase 6, resort every 12, tile "
                        f"32 margin 6: {resort_rate:.3f} steps/s); B4 "
                        f"launches {launches}; spill patched {st.spill}, "
                        f"dropped {st.spill_dropped}, unplaced "
                        f"{int(st.unplaced)}; Gauss residual {r0:.6g} -> "
                        f"{r1:.6g} over {st.step} steps")

    # B4 against its plain version and its bound on the rung's own inputs
    # (tile 16, margin 7, the repair layout with relocated rows)
    from fusion_sim_torch.ops import fdtd
    table = fdtd.center_fields(st.e, st.b, fdtd.E_OFFSETS_2D,
                               fdtd.B_OFFSETS_2D)
    args = em_substep_args(sim.config, sim.tiling, table, st)
    _, report = compare_fused(
        torch, "B4", fe.fused_em2d_substep(*args),
        fe.fused_em2d_substep_plain(*args), args[3], "J")
    k_ms = median_ms(torch, lambda: fe.fused_em2d_substep(*args))
    p_ms = median_ms(torch, lambda: fe.fused_em2d_substep_plain(*args),
                     reps=3, warm=1)
    b_ms, b_by, b_bytes = em_bound_ms(rows, n, sim.config.grid_shape,
                                      sim.tiling.block)
    log("11 EM repair", f"em2d_substep on the repair rung's inputs ({rows} "
                        f"rows): {report}; kernel {k_ms:.4f} ms "
                        f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s "
                        f"effective), plain {p_ms:.4f} ms, bound "
                        f"{b_ms:.4f} ms ({b_by})")
    del args, table
    profile_window(torch, "11 EM repair", f"{steps} steps",
                   lambda: sim.step(steps))


# -- 13. the port's bench at full size ------------------------------------------

# bench.py:318-442's keys (``skipped_sections`` only when a section was
# skipped, which this phase counts as a failure)
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "grid_mode_sorted_at_16m",
    "es_pic_at_10m", "fused_pic_updates_per_sec_at_10m",
    "fused_pic_updates_per_sec_at_10m_unit", "energy_drift_10k_parity",
    "energy_drift_10k", "grid_mode_sorted", "grid_mode_value",
    "grid_mode_value_unit", "es_pic_at_10m_f32_highest", "es_pic_at_10m_xla",
    "wall_time_s"}


def phase13_bench(smi, timeout_s: float = 600):
    """``python -m fusion_sim_torch.bench`` in a process of its own, as a
    user runs it; its JSON line is checked key by key."""
    from fusion_sim_torch.bench import N_ES

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fusion_sim_torch.bench"],
                          cwd=HERE, capture_output=True, text=True,
                          timeout=timeout_s)
    for line in proc.stderr.splitlines():
        if line.startswith("[bench]"):
            log("13 bench", line[8:])
    if proc.returncode != 0:
        raise AssertionError(f"the bench exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    log("13 bench", f"{smi}: {time.perf_counter() - t0:.1f} s; "
                    f"{json.dumps(result)}")
    if set(result) != BENCH_KEYS:
        raise AssertionError(f"keys {sorted(set(result) ^ BENCH_KEYS)} "
                             f"differ from bench.py's")
    for key in ("value", "vs_baseline", "grid_mode_value",
                "fused_pic_updates_per_sec_at_10m"):
        if not (isinstance(result[key], float) and math.isfinite(result[key])
                and result[key] > 0):
            raise AssertionError(f"{key} is {result[key]!r}")
    for key in ("grid_mode_sorted_at_16m", "es_pic_at_10m",
                "energy_drift_10k_parity", "energy_drift_10k",
                "grid_mode_sorted", "es_pic_at_10m_f32_highest",
                "es_pic_at_10m_xla"):
        sec = result[key]
        if not (isinstance(sec, dict) and isinstance(sec.get("value"), float)
                and math.isfinite(sec["value"])):
            raise AssertionError(f"{key} is {sec!r}")
        if sec.get("dropped", 0) or sec.get("dropped_over", 0):
            raise AssertionError(f"{key} dropped rows: {sec}")
    if not result["energy_drift_10k_parity"]["value"] < 1e-3:
        raise AssertionError(f"parity drift "
                             f"{result['energy_drift_10k_parity']} (bar "
                             f"1e-3)")
    updates = result["fused_pic_updates_per_sec_at_10m"]
    if not math.isclose(updates, result["es_pic_at_10m"]["value"] * N_ES,
                        rel_tol=1e-12):
        raise AssertionError(f"updates/s {updates} != steps/s x {N_ES}")
    return result


# -- 14. the ported examples at their default widths -----------------------------

def decode_ppm(data: bytes) -> np.ndarray:
    head = data.split(b"\n", 3)
    if head[0] != b"P6" or head[2] != b"255":
        raise AssertionError(f"not a binary 8-bit PPM: {head[:3]}")
    w, h = (int(x) for x in head[1].split())
    return np.frombuffer(head[3], np.uint8).reshape(h, w, 3)


class tee_stdout:
    """Copies what is printed inside the block into a StringIO (the
    ``as`` value) while it still goes to standard output."""

    def __enter__(self):
        import io

        self.buffer, self.stdout = io.StringIO(), sys.stdout
        parent = self

        class Tee:
            def write(self, text):
                parent.buffer.write(text)
                return parent.stdout.write(text)

            def flush(self):
                parent.stdout.flush()

        sys.stdout = Tee()
        return self.buffer

    def __exit__(self, *exc):
        sys.stdout = self.stdout
        return False


def finite_numbers(res) -> list:
    """Every number of an example's result (nested dicts, lists, tuples);
    raises unless all are finite."""
    values = []

    def walk(v):
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            values.append(float(v))

    walk(res)
    if not values or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"figures not finite: {res}")
    return values


def phase14_examples(torch, smi, kernel_modules):
    """Each ported example's ``main`` once on the card at its default width
    (steps cut where an earlier phase times the same configuration); the
    launches of each by kernel module, and each one's own check."""
    import tempfile

    from fusion_sim_torch.examples import (bench_3d, bench_em_fused,
                                           bench_es_fused, bench_gather,
                                           bench_pusher, bench_resort,
                                           bench_rng, bench_sharded_1chip,
                                           bench_slab_capacity,
                                           bench_weak_scaling,
                                           default_scenario, drift_control,
                                           probe_es_spill,
                                           probe_kernel_floor,
                                           probe_pusher_flux,
                                           probe_pusher_matrix,
                                           profile_es_step, profile_kernels,
                                           profile_pusher, profile_repair,
                                           two_stream, weibel)
    from fusion_sim_torch.utils.png import decode_png

    def need(ok, what):
        if not ok:
            raise AssertionError(what)

    def check_two_stream(res, out):
        g, th = res["gamma"], res["gamma_theory"]
        need(abs(g - th) < 0.1 * th, f"two-stream rate {g} vs {th}")
        need(decode_png(out.read_bytes()).shape == (200, 400, 3), "figure")
        return f"rate {g:.4f} vs theory {th:.4f} ({100 * abs(g - th) / th:.2f}% off)"

    def check_weibel(res, out):
        g = res["gamma"]
        need(math.isfinite(g) and g > 0, f"Weibel rate {g}")
        need(decode_png(out.read_bytes()).shape == (128, 128, 3), "figure")
        return f"rate {g:.4f} vs v0 {res['v0']} ({100 * abs(g - res['v0']) / res['v0']:.1f}% off)"

    def check_frame(res, out):
        img = decode_ppm(out.read_bytes())
        need(img.shape == (800, 400, 3) and img.max() > 0, "frame")
        return f"frame {img.shape}, max {img.max()}"

    def check_dropped(res, out):
        need(all(v == 0 for k, v in res.items() if "dropped" in k),
             f"dropped rows: {res}")
        return ", ".join(f"{k} {v:.6g}" for k, v in res.items())

    def check_slab(res, out):
        # the reference's slab rung (margin 2, resort 8 on cells of 2 pi /
        # 512) spills past its 16384-row patch buffer; its drops are
        # reported, as the example reports them, not gated
        total = torch.cuda.get_device_properties(0).total_memory / 1e9
        need(math.isfinite(res["ms"]) and 0 < res["peak_gb"] < total,
             f"slab {res}")
        return (f"{res['ms']:.3f} ms/step, peak {res['peak_gb']:.2f} of "
                f"{total:.2f} GB; {res['dropped']} deposits dropped over "
                f"{res['steps']} steps (not exact)")

    def check_sharded(res, out):
        # the sharded rungs' drops are the reference's configuration's
        # (phase 15): shown, not gated
        need(res["overflow"] == 0 and math.isfinite(res["ratio"]),
             f"sharded {res}")
        return (f"{res['ms']:.3f} ms/step against {res['single_ms']:.3f} "
                f"single-device, ratio {res['ratio']:.3f}x; dropped "
                f"{res['dropped']} (single-device {res['single_dropped']})")

    def check_weak(res, out):
        need(len(res) == 3 and all(math.isfinite(r[2]) for r in res),
             f"weak scaling rows {res}")
        return ", ".join(f"{r[0]} {r[2]:.3f} ms/step" for r in res)

    def check_figures(res, out):
        values = finite_numbers(res)
        return f"{len(values)} figures, all finite"

    def check_spill(res, out):
        # the totals it prints are the model's counters
        need(res["dropped_total"] == res["spill_dropped"], f"spill {res}")
        need(sum(s for s, _ in res["deltas"]) == res["spill_walked"]
             and sum(d for _, d in res["deltas"]) == res["dropped_walked"]
             and res["peak"] == max(s + d for s, d in res["deltas"]),
             f"spill walk {res}")
        finite_numbers(res)
        return (f"peak {res['peak']} rows a step, dropped {res['dropped_total']}"
                f", {res['rate']:.3f} steps/s over the timed windows")

    def check_matrix(res, out):
        finite_numbers(res)
        exact = [r[1] for r in res["results"] if r[2] == (0, 0)]
        need(res["best"] in exact if exact else res["best"] is None,
             f"matrix {res}")
        return f"best exact rung {res['best'] or 'none'}"

    def check_floor(res, out):
        finite_numbers(res)
        t = next(iter(res.values()))
        need(t["no_both"] < t["base"], f"kernel floor {t}")
        return (f"baseline {t['base']:.4f} ms, no_gather "
                f"{t['no_gather']:.4f}, no_deposit {t['no_deposit']:.4f}, "
                f"no_both {t['no_both']:.4f}")

    steps = ["--steps", "2"]
    runs = (
        ("two_stream", two_stream.main, [], check_two_stream, ()),
        ("weibel", weibel.main, [], check_weibel, ()),
        ("default_scenario", default_scenario.main, [], check_frame, ()),
        ("bench_es_fused", bench_es_fused.main, steps, check_dropped,
         ("fused_pic",)),
        ("bench_em_fused fused,pallas", bench_em_fused.main,
         steps + ["--backends", "fused,pallas"], check_dropped,
         ("fused_em", "sorted_gather")),
        ("bench_pusher fused", bench_pusher.main, steps, check_dropped,
         ("fused_pusher",)),
        ("bench_pusher pallas", bench_pusher.main,
         steps + ["--backend", "pallas"], check_dropped, ("sorted_gather",)),
        ("bench_3d es", bench_3d.main,
         steps + ["--model", "es", "--backend", "pallas"], check_dropped,
         ("fused_pic3d",)),
        ("bench_3d em", bench_3d.main, steps, check_dropped,
         ("fused_em3d",)),
        ("drift_control f32", drift_control.main,
         ["--steps", "300", "--every", "100"], check_dropped, ()),
        ("drift_control f64", drift_control.main,
         ["--steps", "300", "--every", "100", "--dtype", "f64"],
         check_dropped, ()),
        ("bench_slab_capacity", bench_slab_capacity.main, [], check_slab,
         ("fused_pic3d",)),
        ("bench_sharded_1chip em 2D", bench_sharded_1chip.main,
         steps + ["--model", "em"], check_sharded, ("fused_em",)),
        ("bench_sharded_1chip em 3D", bench_sharded_1chip.main,
         steps + ["--model", "em", "--dim", "3"], check_sharded,
         ("fused_em3d",)),
        ("bench_sharded_1chip es --mesh2d", bench_sharded_1chip.main,
         steps + ["--model", "es", "--mesh2d"], check_sharded,
         ("fused_pic",)),
        ("bench_sharded_1chip em --mesh2d", bench_sharded_1chip.main,
         steps + ["--model", "em", "--mesh2d"], check_sharded,
         ("fused_em",)),
        ("bench_weak_scaling --devices 1", bench_weak_scaling.main,
         steps + ["--devices", "1"], check_weak, ()),
    )
    # the probe, microbench and profiling examples at their defaults
    a6_runs = (
        ("probe_es_spill", probe_es_spill.main, [], check_spill,
         ("fused_pic",)),
        ("probe_pusher_flux --fine", probe_pusher_flux.main, ["--fine"],
         check_figures, ("fused_pusher",)),
        ("probe_pusher_matrix", probe_pusher_matrix.main, [], check_matrix,
         ("fused_pusher",)),
        ("bench_resort", bench_resort.main, [], check_figures, ()),
        ("bench_resort --n 10002432", bench_resort.main,
         ["--n", "10002432"], check_figures, ()),
        ("bench_resort --n 29997056 --dim 3", bench_resort.main,
         ["--n", "29997056", "--dim", "3", "--tiles", "4096"],
         check_figures, ()),
        ("bench_gather", bench_gather.main, [], check_figures,
         ("sorted_gather",)),
        ("bench_rng", bench_rng.main, [], check_figures, ()),
        ("profile_es_step", profile_es_step.main, [], check_figures,
         ("fused_pic",)),
        ("profile_pusher", profile_pusher.main, [], check_figures,
         ("fused_pusher",)),
        ("profile_repair", profile_repair.main, [], check_figures, ()),
        ("profile_kernels es2d", profile_kernels.main, ["--which", "es2d"],
         check_figures, ("fused_pic",)),
        ("profile_kernels em2d", profile_kernels.main, ["--which", "em2d"],
         check_figures, ("fused_em",)),
        ("profile_kernels es3d", profile_kernels.main, ["--which", "es3d"],
         check_figures, ("fused_pic3d",)),
        ("profile_kernels em3d", profile_kernels.main, ["--which", "em3d"],
         check_figures, ("fused_em3d",)),
        ("profile_kernels pusher", profile_kernels.main,
         ["--which", "pusher"], check_figures, ("fused_pusher",)),
        ("probe_kernel_floor", probe_kernel_floor.main, [], check_floor,
         ("fused_pic",)),
    )
    a6 = {label for label, *_ in a6_runs}
    runs += a6_runs
    fp = next(m for m in kernel_modules if m.__name__.endswith(".fused_pic"))
    by_run = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, main, argv, check, kernels in runs:
            out = Path(tmp) / "out"
            if main in (two_stream.main, weibel.main, default_scenario.main):
                argv = argv + ["--out", str(out)]
            zero_counts(kernel_modules)
            t0 = time.perf_counter()
            if label in a6:
                # every figure these print must be finite
                with tee_stdout() as printed:
                    res = main(argv)
                bad = re.findall(r"(?i)\b(?:nan|inf)\b", printed.getvalue())
                need(not bad, f"{label} printed {bad}")
            else:
                res = main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
                        for m in kernel_modules if m.LAUNCHES}
            for name in kernels:
                need(launched.get(name, 0) > 0,
                     f"{label}: no launch of {name} ({launched})")
            log("14 examples", f"{label}: {secs:.1f} s; {check(res, out)}; "
                               f"launches {launched or 'none'}")
            by_run[label] = {"launched": launched, "res": res,
                             "b1_forms": dict(fp.FORM_LAUNCHES)}
            torch.cuda.empty_cache()
    log("14 examples", f"{smi}: every example ran")
    return by_run


# -- 15. the sharded ES model in a world of one (kernels B1, B5) ----------------

def sharded_es_rung(es, shd, Tiling2D, Tiling3D, ndim: int, repair: bool):
    """The ES half of the reference's one-chip sharded bench
    (examples/bench_sharded_1chip.py:86-146), its configuration's source:
    10,002,432 particles on 512^2 (2D, ``Tiling2D(32, 32, 1024, margin
    6)``, resort 16, spill 16,384) or 29,997,056 on 128^3 (3D,
    ``Tiling3D((8, 8, 8), 512, margin 2)``, resort 6, spill 65,536); L = 2
    pi, dt 0.05, charge -vol/n and mass vol/n, velocities 0.05 N(0, 1)
    from seed 0, one shard, migration buffer 8,192, capacity
    (int(1.05 n) // 1024) * 1024 + 1024.  ``repair``: spill 163,840, 2,048
    free slots a tile, resort 1e9 and a 117-step warm-up to the spill
    equilibrium.  Returns the sharded config, the particles, the
    single-device model's keywords for the same rung and the warm-up."""
    n = 10_002_432 if ndim == 2 else 29_997_056
    nc = 512 if ndim == 2 else 128
    rng = np.random.default_rng(0)
    pos = (rng.random((n, ndim)) * nc).astype(np.float32)
    if ndim == 2:
        tiling, resort = Tiling2D(tile_r=32, tile_z=32, block=1024,
                                  margin=6), 16
    else:
        tiling, resort = Tiling3D(tile=(8, 8, 8), block=512, margin=2), 6
    length = 2 * np.pi
    vol = length ** ndim
    base = es.ESConfig(grid_shape=(nc,) * ndim,
                       cell_size=(length / nc,) * ndim, dt=0.05,
                       charge=-vol / n, mass=vol / n)
    vel = (0.05 * rng.standard_normal((n, ndim))).astype(np.float32)
    spill = 163840 if repair else (16384 if ndim == 2 else 65536)
    free = 2048 if repair else 256
    resort = 10 ** 9 if repair else resort
    cfg = shd.ShardedESConfig(
        base=base, n_shards=1, capacity=(int(n * 1.05) // 1024) * 1024 + 1024,
        migration_buffer=8192, tiling=tiling, resort_every=resort,
        repair=repair, backend="pallas", spill_capacity=spill,
        repair_free_slots=free)
    single_kw = dict(tiling=tiling, resort_every=resort, spill_capacity=spill,
                     backend="pallas", repair=repair, repair_free_slots=free,
                     check_spill=False)
    return cfg, pos, vel, single_kw, (117 if repair else 0)


def hold_steps(torch, label, sim, single, steps: int, check,
               may_drop: bool = False, before_step=None) -> str:
    """Step a sharded model and the single-device model one step at a time
    from the same positions, up to ``steps``, then hold them once with
    ``check(k)`` (it raises AssertionError where they disagree; returns
    its report).  A step in which either model drops a deposit (a row past
    the spill capacity: not exact) fails the hold; with ``may_drop`` (a
    rung that drops by its configuration's design) the hold ends at the
    step before it instead, whose states are held (the models step
    functionally, so the kept states stay as they were), and the report
    says so.  ``before_step(k)`` runs before step k where given."""
    def dropped(m):
        return int(torch.as_tensor(m.state.spill_dropped).sum())

    held, kept = 0, None
    for k in range(1, steps + 1):
        if before_step is not None:
            before_step(k)
        prev = (sim.state, single.state)
        before = (dropped(sim), dropped(single))
        sim.step(1)
        single.step(1)
        if (dropped(sim), dropped(single)) != before:
            drop = (f"step {k} dropped deposits (sharded {dropped(sim)}, "
                    f"single-device {dropped(single)})")
            if not may_drop or k == 1:
                raise AssertionError(f"{label}: {drop} inside the hold")
            kept = prev
            break
        held = k
    if kept is None:
        return check(held)
    now = (sim.state, single.state)
    sim.state, single.state = kept
    try:
        report = check(held)
    finally:
        sim.state, single.state = now
    return f"{report}; {drop}, so the hold ends at {held}"


def sorted_positions_within(torch, label, cfg, st, ss) -> float:
    """The live rows' sorted positions of two models, axis by axis (the
    layouts differ, so no row-for-row compare), within 1e-3 of a cell.
    The axes are periodic: a row within an ulp of the period's end may sit
    at n - eps in one model and at 0 in the other, which shifts one sorted
    column against the other by a place (and reads the largest gap between
    neighbouring rows, ~8e-4 cells at 10 M rows on 512 cells, as a
    difference); the sorted columns are compared at the cyclic shift of
    up to two places that aligns them best, the wrapped rows moved by the
    period."""
    grid = torch.tensor(cfg.base.grid_shape, dtype=torch.float32,
                        device=st.position.device)
    ps = torch.remainder(st.position[st.alive], grid)
    p1 = torch.remainder(ss.position[ss.valid], grid)
    if ps.shape != p1.shape:
        raise AssertionError(f"{label}: {ps.shape[0]} live rows against "
                             f"{p1.shape[0]}")
    dmax = 0.0
    for a, n in enumerate(cfg.base.grid_shape):
        x, y = torch.sort(ps[:, a]).values, torch.sort(p1[:, a]).values
        best = float("inf")
        for k in range(-2, 3):
            # y shifted k places round the period
            if k > 0:
                z = torch.cat([y[-k:] - n, y[:-k]])
            elif k < 0:
                z = torch.cat([y[-k:], y[:-k] + n])
            else:
                z = y
            best = min(best, float((x - z).abs().max()))
        dmax = max(dmax, best)
    if dmax > 1e-3:
        raise AssertionError(f"{label}: sorted positions differ by {dmax}")
    return dmax


def sharded_vs_single(torch, label, cfg, sim, single, steps: int,
                      own_tol: float = 1e-5, may_drop: bool = False):
    """``steps`` steps of the sharded ES model against the single-device
    fused model from the same positions (``hold_steps``), held at the
    last: the kinetic energy within 1e-5, the sorted positions within 1e-3
    of a cell (the card-vs-CPU checks' bar) and the folded rho (the whole
    grid at one shard) within 1e-4 of its max.  The shard works in its
    pseudo-grid frame, x + halo_w rounded to f32 each step, so its rows
    drift from the single-device model's by ulps of x + halo_w (up to
    ~1.6e-4 cells after 4 steps at 512^2): rho is held at ``own_tol``
    against the shard's own deposit in its frame too (the kernel's
    deposit, the patch and the apron fold, up to summation order and the
    rounding of the stored positions).  The report gives one row's
    deposit beside it, the least a lost or doubled deposit would show."""
    mass = cfg.base.mass

    def kinetic(v, live):
        return 0.5 * mass * float(
            (torch.where(live[:, None], v, 0.0).double() ** 2).sum())

    def check(k):
        st, ss = sim.state, single.state
        seed = sim._seed_rho(st)
        scale = float(seed.abs().max())
        own_err = float((st.rho - seed).abs().max()) / scale
        one_row = abs(cfg.base.charge) / cfg.base.cell_volume / scale
        if not own_err <= own_tol:
            raise AssertionError(f"{label}: step {k}: carried rho vs its "
                                 f"own deposit {own_err} of its max (limit "
                                 f"{own_tol:g})")
        rho_err = float((st.rho - ss.rho).abs().max()) / float(
            ss.rho.abs().max())
        if not rho_err <= 1e-4:
            raise AssertionError(f"{label}: step {k}: rho {rho_err} of its "
                                 f"max against the single-device model")
        ke_s = kinetic(st.velocity, st.alive)
        ke_1 = kinetic(ss.velocity, ss.valid)
        if not math.isclose(ke_s, ke_1, rel_tol=1e-5):
            raise AssertionError(f"{label}: step {k}: kinetic {ke_s} vs "
                                 f"{ke_1}")
        dmax = sorted_positions_within(torch, label, cfg, st, ss)
        return (f"carried rho within {own_err:.3g} of its max against the "
                f"shard's own deposit (limit {own_tol:g}; one row's "
                f"deposit {one_row:.3g}); {k} steps against "
                f"SortedElectrostaticPIC(backend='pallas'): rho within "
                f"{rho_err:.3g} of its max, kinetic {ke_s:.9g} / "
                f"{ke_1:.9g}, sorted positions within {dmax:.3g}")

    return hold_steps(torch, label, sim, single, steps, check, may_drop)


def sharded_pieces(torch, shd, sim, single, substep, args) -> str:
    """The sharded fused step's pieces on its current state, ms each (CUDA
    events, median of 5): the frame shift into the pseudo-grid, the solve
    with its halos, the kernel, the spill mask and count, the wrap back
    (with migration or repair and the dead rows' zeroing), one whole
    step; and the single-device step beside it."""
    from fusion_sim_torch.ops.interp import patch_rows

    cfg, ring, st = sim.config, sim._ring, sim.state
    out = substep(*args)
    mask = (~out[3] | (st.tile_id >= shd._n_tiles(cfg))) & st.alive
    _, idx = patch_rows(mask, (cfg.spill_capacity,))
    ok = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    pieces = (
        ("frame shift", lambda: shd._to_local(cfg, st.position, ring.x_lo)),
        ("solve + halos", lambda: shd._solve_e_pad(cfg, ring, st.rho,
                                                   cfg.halo_w)),
        ("kernel", lambda: substep(*args)),
        ("spill mask + count", lambda: patch_rows(
            (~out[3] | (st.tile_id >= shd._n_tiles(cfg))) & st.alive,
            (cfg.spill_capacity,))),
        ("wrap back", lambda: shd._wrap_and_migrate(
            cfg, ring, st, out[0], out[1], st.alive,
            st.overflow, idx, ok, mask, shd._n_tiles(cfg))),
        ("whole step", lambda: sim._step(st)),
        ("single-device step", (single._step_pallas if single.backend
                                == "pallas" else single._step_xla)))
    times = []
    for name, fn in pieces:
        keep = single.state
        times.append(f"{name} {median_ms(torch, fn, reps=5, warm=1):.4f}")
        single.state = keep
    return "ms: " + ", ".join(times) + f" ({idx.shape[0]} rows spilled)"


def timed_steps(torch, sim, steps: int, chunk: int):
    """(steps/s, ms a step) over ``steps`` steps in calls of ``chunk``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps // chunk):
        sim.step(chunk)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return steps / secs, 1e3 * secs / steps


def phase15_sharded(torch, es, fp, f3, Tiling2D, Tiling3D, smi,
                    kernel_modules):
    """``ShardedElectrostaticPIC(backend='pallas')`` on the card in a world
    of one (NCCL, started by ``make_mesh``): the 2D rung, its repair form
    and the 3D rung of ``sharded_es_rung``.  Each holds its kernel against
    the plain version on the shard's own pseudo-grid inputs, holds a few
    steps against the single-device fused model, needs no overflow and a
    move under the halo's bound, and prints steps/s, ms a step, the drops
    and (repair) unplaced rows of both models, device busy, the kernel's
    launches and ms, and the ratio
    to the single-device fused step (the reference's bar is 1.3x: shown,
    not enforced)."""
    import torch.distributed as dist

    from fusion_sim_torch.models import electrostatic_sharded as shd
    from fusion_sim_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, ("space",))
    log("15 sharded", f"world of {dist.get_world_size()} "
                      f"({dist.get_backend()}), mesh {mesh}")
    entries = []
    for label, ndim, repair in (("2D", 2, False), ("2D repair", 2, True),
                                ("3D", 3, False)):
        t0 = time.perf_counter()
        cfg, pos, vel, single_kw, warmup = sharded_es_rung(
            es, shd, Tiling2D, Tiling3D, ndim, repair)
        n = pos.shape[0]
        sim = shd.ShardedElectrostaticPIC(cfg, mesh, pos, vel)
        single = es.SortedElectrostaticPIC(cfg.base, pos, vel, **single_kw)
        del pos, vel
        torch.cuda.synchronize()
        kmod, kname = (fp, "B1") if ndim == 2 else (f3, "B5")
        log("15 sharded", f"{label}: set-up {time.perf_counter() - t0:.2f} s "
                          f"({n} particles, pseudo-grid {cfg.pseudo_shape} "
                          f"(halo {cfg.halo_w}), {sim.state.position.shape[0]}"
                          f" shard rows against {single.state.position.shape[0]}"
                          f" single-device rows)")
        log("15 sharded", f"{label}: " + sharded_vs_single(
            torch, label, cfg, sim, single, 4))

        # the kernel against its plain version on the shard's inputs
        args = sim.fused_substep_args()
        substep = (kmod.fused_es2d_substep if ndim == 2
                   else kmod.fused_es3d_substep)
        plain = (kmod.fused_es2d_substep_plain if ndim == 2
                 else kmod.fused_es3d_substep_plain)
        err, report = compare_fused(torch, kname, substep(*args),
                                    plain(*args), args[3] != 0, "rho")
        log("15 sharded", f"{label}: {kname} on the shard's pseudo-grid "
                          f"inputs: {report}")

        for _ in range(warmup):
            sim.step(1)
            single.step(1)
        window = 16 if ndim == 2 else 6
        steps = 2 * window if ndim == 2 else 3 * window
        zero_counts(kernel_modules)
        rate, ms = timed_steps(torch, sim, steps, window)
        launches = kmod.LAUNCHES
        if launches != steps:
            raise AssertionError(f"{label}: {kname} launches {launches} != "
                                 f"steps {steps}")
        rate_1, ms_1 = timed_steps(torch, single, steps, window)
        st = sim.state
        inv = sim.check_invariants()
        if inv["overflow"]:
            raise AssertionError(f"{label}: overflow {inv['overflow']}")
        # unplaced: relocations that found their tile's stack empty keep
        # their exact patch (nothing is lost); the sharded layout is built
        # with reserve but not spread (the reference's), so its stacks
        # hold a tile's pad only: shown beside the single-device count
        unplaced = (int(st.unplaced.sum()), int(single.state.unplaced)) \
            if repair else None
        # rows past spill_capacity lose their deposits; the reference's 2D
        # rung (resort 16 at margin 6) spills past its 16,384 late in a
        # window, in both models: shown, as the slab rung's are (phase 14)
        dropped = int(st.spill_dropped.sum())
        dropped_1 = single.state.spill_dropped
        # the sorted compositions' aprons are halo_w cells wide: a row may
        # move less than halo_w - 1 cells a step (and half a slab for the
        # migration masks).  The reference's disp_bound, APRON_W - 1 = 1
        # cell, is the plain composition's apron; the 2D rungs' thermal
        # tail (0.2 cells a step per unit of N(0, 1), over 2e7 draws)
        # passes it: shown, not gated
        halo_bound = min(cfg.slab / 2, cfg.halo_w - 1)
        if not inv["max_disp_cells"] < halo_bound:
            raise AssertionError(f"{label}: displacement {inv} past the "
                                 f"halo's bound {halo_bound}")
        for name in ("position", "velocity", "rho"):
            if not bool(torch.isfinite(getattr(st, name)).all()):
                raise AssertionError(f"{label}: state.{name} not finite")
        n_live = int(st.alive.sum())
        if n_live != n:
            raise AssertionError(f"{label}: {n_live} live rows, expected {n}")
        log("15 sharded", f"{label} {smi}: {steps} timed steps, {rate:.3f} "
                          f"steps/s, {ms:.4f} ms/step; single-device fused "
                          f"{rate_1:.3f} steps/s, {ms_1:.4f} ms/step; ratio "
                          f"{ms / ms_1:.3f}x (the reference's bar: 1.3x); "
                          f"{kname} launches {launches}; spill patched "
                          f"{int(st.spill.sum())}, dropped past the "
                          f"capacity {dropped} (single-device {dropped_1}),"
                          f" overflow 0" + (f", unplaced {unplaced[0]} "
                                            f"(single-device {unplaced[1]})"
                                            if repair else "")
                          + f", max displacement "
                          f"{inv['max_disp_cells']:.4f} cells a step (the "
                          f"halo's bound {halo_bound:g}; the reference's "
                          f"disp_bound {cfg.disp_bound:g} "
                          + ("held)" if inv["disp_bound_ok"] else
                             "passed by the thermal tail)"))

        args = sim.fused_substep_args()
        log("15 sharded", f"{label} pieces on the timed run's state, "
                          + sharded_pieces(torch, shd, sim, single, substep,
                                           args))
        k_ms = median_ms(torch, lambda: substep(*args))
        p_ms = median_ms(torch, lambda: plain(*args), reps=3, warm=1)
        rows, n_valid = args[1].shape[0], int((args[3] != 0).sum())
        bound_fn = substep_bound_ms if ndim == 2 else es3d_bound_ms
        b_ms, b_by, _ = bound_fn(rows, n_valid, cfg.pseudo_shape,
                                 cfg.tiling.block)
        log("15 sharded", f"{label}: {kname} on the shard's inputs ({rows} "
                          f"rows): kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                          f"ms, bound {b_ms:.4f} ms ({b_by})")
        del args
        profile_window(torch, "15 sharded", f"{label}, {window} steps",
                       lambda: sim.step(window))
        entries.append({
            "name": f"{kname}:{'es2d' if ndim == 2 else 'es3d'}_substep, "
                    f"sharded ES {label} (one shard's pseudo-grid)",
            "route": "cuda",
            "source": ("fusion_sim_torch/csrc/es2d_substep.cu" if ndim == 2
                       else "fusion_sim_torch/csrc/es3d_substep.cu"),
            "replaces": ("fusion_sim_tpu/ops/pallas_pic.py:271" if ndim == 2
                         else "fusion_sim_tpu/ops/pallas_pic3d.py:213"),
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
        del sim, single
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return entries


# -- 16. the sharded EM model and the two-axis models (kernels B1, B4-B6) ------

# The runs, built by the port's examples/bench_sharded_1chip.build_sim with
# the reference script's flags (examples/bench_sharded_1chip.py:84-178, the
# configurations' source; nothing cut): the EM half at 10,002,432 particles
# on 512^2 (Tiling2D(32, 32, 1024, margin 6), resort 12; repair: resort
# 1e9) and 29,997,056 on 128^3 (Tiling3D((8, 8, 8), 512, margin 2), resort
# 6), cells 0.5, dt 0.1, charge -0.01, mass 0.01, centered gather,
# velocities 0.05 N(0, 1) from seed 0, migration buffer 8,192, capacity
# (int(1.05 n) // 1024) * 1024 + 1024; the --mesh2d forms on a (1, 1) mesh
# (the ES ones at phase 15's rungs).  (label, flags, kernel, held against
# the single-device model)
SHARDED_RUNS = (
    ("EM slab 2D", ["--model", "em"], "B4", True),
    ("EM slab 2D repair", ["--model", "em", "--repair"], "B4", True),
    ("EM slab 3D", ["--model", "em", "--dim", "3"], "B6", True),
    ("two-axis ES 2D", ["--model", "es", "--mesh2d"], "B1", True),
    ("two-axis EM 2D", ["--model", "em", "--mesh2d"], "B4", True),
    ("two-axis ES 3D", ["--model", "es", "--mesh2d", "--dim", "3"], "B5",
     False),
    ("two-axis EM 3D", ["--model", "em", "--mesh2d", "--dim", "3"], "B6",
     False),
)


def sharded_em_vs_single(torch, em, label, sim, single, steps: int):
    """``steps`` (at least 3) steps of a sharded EM model against the
    single-device fused model from the same positions (``hold_steps``):
    the current J of step 1 (as each model hands it to its Yee update)
    within 1e-4 of its max, J of step 3 within 1e-4 of its max against a
    single-device twin seeded from the sharded state, and at the last step
    kinetic and field energy within 1e-5 and sorted positions within 1e-3
    of a cell.

    The shard works in its pseudo-grid frame, x + halo_w in f32 (and y +
    halo_y on the two-axis mesh), and J is a difference of positions
    (Esirkepov's S(x1) - S(x0) over a drift of ~0.01 cells): a frame
    rounding of one ulp of x + halo_w (up to 6e-5 cells at 512^2) moves a
    row's J by up to a few 1e-3, so after the first step the two models'
    J drift ~1e-4 of max apart with no fault (CPU, 128^2: 1.3e-4 at step
    2).  Step 1 therefore starts both models from positions the frame
    holds exactly (each moved by under an ulp to (x + h) - h), on the
    initial zero E and B.  Step 3 runs on live fields: before it the
    sharded model is resorted (so no row is patched in the frame) and its
    positions are made frame-exact, and a single-device twin is built from
    its live rows, E and B; the step's J then reads the sharded E|B halos,
    centered table, gather and kick against the twin's periodic ones (CPU,
    128^2 and 32^3: 1.7e-7 to 2.9e-7 of max sound; 1.5e-2 with the shard's
    E zeroed on two cells at each x edge, 1.7e-2 with its E and B
    zeroed; H100, this phase's rungs: 7.7e-8 to 1.5e-6)."""
    from fusion_sim_torch.models import electromagnetic_sharded as m1
    from fusion_sim_torch.models import electromagnetic_sharded2d as m2

    two_axis = hasattr(sim, "_m2")
    mod = m2 if two_axis else m1
    halos = sim.config.halo_ws if two_axis else (sim.config.halo_w,)
    base = sim.config.base
    got = {"sharded": [], "single": [], "twin": []}
    yee, finish = mod._yee_local, single._finish

    def snap(*states):
        for st in states:
            for a, h in enumerate(halos):
                st.position[:, a] = (st.position[:, a] + h) - h

    def hook(side, fn):
        # _yee_local(base, e, b, j, groups) and _finish(state, x1,
        # velocity, j, spill): one call a step, J fourth
        def call(*a, **kw):
            got[side].append(a[3].clone())
            return fn(*a, **kw)
        return call

    def twin_step(k):
        if k != 3:
            return
        st = sim.state
        snap(st)
        # the shell resorts before its next step (and, with repair,
        # re-inits the free lists)
        sim._since_sort = sim.config.resort_every
        live = st.alive
        twin = type(single)(
            single.config, st.position[live].cpu().numpy(),
            st.velocity[live].cpu().numpy(), tiling=single.tiling,
            resort_every=single.resort_every, gather_backend="fused",
            repair=single.repair, pallas_precision=single.pallas_precision,
            check_spill=False, device=single.device)
        twin.state = twin.state._replace(e=st.e.clone(), b=st.b.clone())
        twin._finish = hook("twin", twin._finish)
        twin.step(1)

    def energies(v, live, e, b):
        kin = 0.5 * base.mass * float(
            (torch.where(live[:, None], v, 0.0).double() ** 2).sum())
        mu0 = 1.0 / (base.eps0 * base.c ** 2)
        field = (0.5 * base.eps0 * float((e.double() ** 2).sum())
                 + 0.5 / mu0 * float((b.double() ** 2).sum())
                 ) * base.cell_volume
        return kin, field

    def check(k):
        st, ss = sim.state, single.state
        ke_s, fe_s = energies(st.velocity, st.alive, st.e, st.b)
        ke_1, fe_1 = energies(ss.velocity, ss.valid, ss.e, ss.b)
        for name, a, b in (("kinetic", ke_s, ke_1), ("field", fe_s, fe_1)):
            if not math.isclose(a, b, rel_tol=1e-5):
                raise AssertionError(f"{label}: step {k}: {name} energy "
                                     f"{a} vs {b}")
        dmax = sorted_positions_within(torch, label, sim.config, st, ss)
        return (f"after {k} steps against SortedElectromagneticPIC("
                f"gather_backend='fused'): kinetic {ke_s:.9g} / {ke_1:.9g}, "
                f"field {fe_s:.9g} / {fe_1:.9g}, sorted positions within "
                f"{dmax:.3g}")

    if steps < 3:
        raise ValueError(f"{label}: the hold needs 3 steps")
    snap(sim.state, single.state)
    mod._yee_local = hook("sharded", yee)
    single._finish = hook("single", finish)
    try:
        report = hold_steps(torch, label, sim, single, steps, check,
                            before_step=twin_step)
    finally:
        mod._yee_local = yee
        del single._finish
    errs = []
    for what, js, j1 in (("step 1's J", got["sharded"][0], got["single"][0]),
                         ("step 3's J against the twin", got["sharded"][2],
                          got["twin"][0])):
        errs.append(float((js - j1).abs().max()) / float(j1.abs().max()))
        if not errs[-1] <= 1e-4:
            raise AssertionError(f"{label}: {what} {errs[-1]} of its max")
    return (f"J within {errs[0]:.3g} of its max at step 1 (frame-exact "
            f"positions, zero fields) and {errs[1]:.3g} at step 3 against a "
            f"single-device twin of the resorted shard (live fields); "
            f"{report}")


def halo_bound(cfg, reach: int) -> float:
    """The cells a step a row may move in a sorted composition: its apron
    is the halo (the stencil reaches ``reach`` cells), and the migration
    masks need under half a block on each decomposed axis."""
    if hasattr(cfg, "halo_ws"):
        halos = cfg.halo_ws
        slabs = [s for s, m in zip(cfg.slabs, cfg.mesh_shape) if m > 1]
    else:
        halos, slabs = (cfg.halo_w,), [cfg.slab]
    return min([h - reach for h in halos] + [s / 2 for s in slabs])


def fused_kernels(fp, f3, fe, fe3) -> dict:
    """id: (module, kernel name, bound, deposit's name, TPU kernel) of the
    kernels the sharded models launch."""
    return {
        "B1": (fp, "es2d", substep_bound_ms, "rho",
               "fusion_sim_tpu/ops/pallas_pic.py:271"),
        "B5": (f3, "es3d", es3d_bound_ms, "rho",
               "fusion_sim_tpu/ops/pallas_pic3d.py:213"),
        "B4": (fe, "em2d", em_bound_ms, "J",
               "fusion_sim_tpu/ops/pallas_em.py:256"),
        "B6": (fe3, "em3d", em3d_bound_ms, "J",
               "fusion_sim_tpu/ops/pallas_em3d.py:253"),
    }


def phase16_sharded(torch, em, fp, f3, fe, fe3, smi, kernel_modules):
    """The sharded EM model (slabs, B4 / B6, resort and repair) and the
    two-axis ES and EM models (B1, B4, B5, B6) in a world of one (NCCL,
    started by ``make_mesh``) at ``SHARDED_RUNS``' rungs.  Each holds its
    kernel bit for bit against the plain version on the shard's own
    pseudo-grid inputs, holds 4 steps against the single-device fused
    model (runs 1-5; the 3D two-axis runs take 2 steps with the invariants
    only), needs no overflow and a move under the halo's bound, and prints
    steps/s, ms a step, device busy, the drops and (repair) unplaced rows,
    the kernel's launches and ms, and the ratio to the single-device fused
    step (timed here on the same rung)."""
    import torch.distributed as dist

    from fusion_sim_torch.examples import bench_sharded_1chip as bsh

    kernels = fused_kernels(fp, f3, fe, fe3)
    entries = []
    for label, flags, kid, held in SHARDED_RUNS:
        t0 = time.perf_counter()
        args = bsh.parse_args(flags)
        sim, _, warmup = bsh.build_sim(args)
        single, _, _ = bsh.build_sim(args, single=True)
        torch.cuda.synchronize()
        cfg = sim.config
        n = int(sim.state.alive.sum())
        is_es = args.model == "es"
        kmod, kname, bound_fn, grid_name, replaces = kernels[kid]
        substep = getattr(kmod, f"fused_{kname}_substep")
        plain = getattr(kmod, f"fused_{kname}_substep_plain")
        log("16 sharded", f"{label}: world of {dist.get_world_size()} "
                          f"({dist.get_backend()}), set-up "
                          f"{time.perf_counter() - t0:.2f} s ({n} particles, "
                          f"pseudo-grid {cfg.pseudo_shape}, "
                          f"{sim.state.position.shape[0]} shard rows against "
                          f"{single.state.position.shape[0]} single-device "
                          f"rows)")

        if held and is_es:
            # the two-axis frame rounds x and y, so the carried rho's own
            # deposit reads a little above the slab's: sound H100 readings
            # 1.02e-5 (step 3) and 1.07e-5 (step 1) of max here, 1.10e-5 on
            # phase 15's slab at step 2.  One row's deposit is ~1.8e-2 of
            # max, and a step that dropped deposits read 0.175: the limit,
            # 2e-5, sits ~2x over the sound readings and ~900x under one
            # lost row.  The rung drops by its design (the y edge's
            # crossers keep their tile until the resort): the hold ends
            # before the first step that drops
            vs = sharded_vs_single(torch, label, cfg, sim, single, 4,
                                   own_tol=2e-5, may_drop=True)
        elif held:
            vs = sharded_em_vs_single(torch, em, label, sim, single, 4)
        else:
            sim.step(2)
            single.step(2)       # both models warm before the timing
            vs = "2 steps, invariants only"
        log("16 sharded", f"{label}: {vs}")

        for _ in range(warmup):
            sim.step(1)
            single.step(1)
        window = cfg.resort_every if cfg.resort_every < 10 ** 6 else 12
        steps = window * (2 if cfg.base.n_dim == 2 else 1)
        zero_counts(kernel_modules)
        rate, ms = timed_steps(torch, sim, steps, window)
        launches = kmod.LAUNCHES
        if launches != steps:
            raise AssertionError(f"{label}: {kid} launches {launches} != "
                                 f"steps {steps}")
        rate_1, ms_1 = timed_steps(torch, single, steps, window)
        st = sim.state
        inv = sim.check_invariants()
        if inv["overflow"]:
            raise AssertionError(f"{label}: overflow {inv['overflow']}")
        bound_cells = halo_bound(cfg, 1 if is_es else 2)
        if not inv["max_disp_cells"] < bound_cells:
            raise AssertionError(f"{label}: displacement {inv} past the "
                                 f"halo's bound {bound_cells}")
        for name in ("position", "velocity", "rho", "e", "b"):
            t = getattr(st, name, None)
            if t is not None and not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label}: state.{name} not finite")
        n_live = int(st.alive.sum())
        if n_live != n:
            raise AssertionError(f"{label}: {n_live} live rows, expected {n}")
        unplaced = ""
        if getattr(cfg, "repair", False):
            unplaced = (f", unplaced {int(st.unplaced.sum())} "
                        f"(single-device {int(single.state.unplaced)})")
        log("16 sharded", f"{label} {smi}: {steps} timed steps, "
                          f"{rate:.3f} steps/s, {ms:.4f} ms/step; "
                          f"single-device fused {rate_1:.3f} steps/s, "
                          f"{ms_1:.4f} ms/step; ratio {ms / ms_1:.3f}x (the "
                          f"reference's bar: 1.3x); {kid} launches "
                          f"{launches}; spill patched {int(st.spill.sum())}, "
                          f"dropped past the capacity "
                          f"{int(st.spill_dropped.sum())} (single-device "
                          f"{int(single.state.spill_dropped)}), overflow 0"
                          f"{unplaced}, max displacement "
                          f"{inv['max_disp_cells']:.4f} cells a step (the "
                          f"halo's bound {bound_cells:g})")

        # the kernel against its plain version on the shard's inputs, on
        # the live fields of the run so far: the gather reads the E (|B)
        # table through the pseudo-grid's window wrap, and the kick moves
        # every charged row
        kargs = sim.fused_substep_args()
        charged = kargs[3] != 0 if is_es else kargs[3]
        table_max = float(kargs[0].abs().max())
        if not table_max > 0:
            raise AssertionError(f"{label}: the field table is all zeros")
        out = substep(*kargs)
        kick = float((out[1] - kargs[2])[charged].abs().max())
        if not kick > 0:
            raise AssertionError(f"{label}: {kid} left every velocity as "
                                 f"it was")
        err, report = compare_fused(torch, kid, out, plain(*kargs), charged,
                                    grid_name)
        del out
        log("16 sharded", f"{label}: {kid} on the shard's pseudo-grid "
                          f"inputs after {steps} timed steps (max|field| "
                          f"{table_max:.3g}, max|dv| of the kick "
                          f"{kick:.3g}): {report}")
        k_ms = median_ms(torch, lambda: substep(*kargs))
        p_ms = median_ms(torch, lambda: plain(*kargs), reps=3, warm=1)
        rows = kargs[1].shape[0]
        n_valid = int(charged.sum())
        b_ms, b_by, _ = bound_fn(rows, n_valid, cfg.pseudo_shape,
                                 cfg.tiling.block)
        log("16 sharded", f"{label}: {kid} on the shard's inputs ({rows} "
                          f"rows): kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                          f"ms, bound {b_ms:.4f} ms ({b_by})")
        del kargs
        profile_window(torch, "16 sharded", f"{label}, {window} steps",
                       lambda: sim.step(window))
        entries.append({
            "name": f"{kid}:{kname}_substep, {label} (one shard's "
                    f"pseudo-grid {'x'.join(map(str, cfg.pseudo_shape))})",
            "route": "cuda",
            "source": f"fusion_sim_torch/csrc/{kname}_substep.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
        del sim, single
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return entries


# -- 17. the multi-device dry run and the config[4] evidence (world of one) ---

def phase17_dryrun(torch, fp, f3, fe, fe3, smi, kernel_modules,
                   slab_peak_gb: float):
    """``dryrun_multichip(1)`` in a world of one (NCCL), every section with
    the reference's asserts; each fused section's kernel held once against
    its plain version at the section's shapes (the state after its step);
    config[4]'s memory table beside the slab rung's peak measured in phase
    14; the 1/8-scale run at one shard."""
    import torch.distributed as dist

    from fusion_sim_torch.entry import dryrun_multichip
    from fusion_sim_torch.examples import config4_evidence

    zero_counts(kernel_modules)
    t0 = time.perf_counter()
    run = dryrun_multichip(1)
    secs = time.perf_counter() - t0
    launched = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES
                for m in kernel_modules if m.LAUNCHES}
    for name in ("fused_pic", "fused_em", "fused_pic3d", "fused_em3d"):
        if not launched.get(name):
            raise AssertionError(f"dry run: no launch of {name} ({launched})")
    log("17 dry run", f"{smi}: dryrun_multichip(1) passed every assert in "
                      f"{secs:.2f} s (world of {dist.get_world_size()}, "
                      f"{dist.get_backend()}); launches {launched}")
    log("17 dry run", "  " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in run.seconds.items()))
    kernels = fused_kernels(fp, f3, fe, fe3)
    entries = []
    for label, sim in run.fused.items():
        kid = label[label.index("(") + 1:-1]
        kmod, kname, bound_fn, grid_name, replaces = kernels[kid]
        substep = getattr(kmod, f"fused_{kname}_substep")
        plain = getattr(kmod, f"fused_{kname}_substep_plain")
        kargs = sim.fused_substep_args()
        charged = kargs[3] != 0 if kid in ("B1", "B5") else kargs[3]
        err, report = compare_fused(torch, f"{label}", substep(*kargs),
                                    plain(*kargs), charged, grid_name)
        k_ms = median_ms(torch, lambda: substep(*kargs))
        p_ms = median_ms(torch, lambda: plain(*kargs), reps=5, warm=1)
        cfg = sim.config
        rows = kargs[1].shape[0]
        b_ms, b_by, _ = bound_fn(rows, int(charged.sum()), kargs[5],
                                 cfg.tiling.block)
        log("17 dry run", f"{label} on its pseudo-grid "
                          f"{'x'.join(map(str, kargs[5]))} ({rows} rows): "
                          f"{report}; kernel {k_ms:.4f} ms, plain "
                          f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        entries.append({
            "name": f"{kid}:{kname}_substep, dry run {label.split(' (')[0]}"
                    f" (pseudo-grid {'x'.join(map(str, kargs[5]))})",
            "route": "cuda",
            "source": f"fusion_sim_torch/csrc/{kname}_substep.cu",
            "replaces": replaces, "launches": launched[kmod.__name__.rsplit(
                ".", 1)[1]], "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    del run
    torch.cuda.empty_cache()

    total = config4_evidence.hbm_budget()
    log("17 dry run", f"{smi}: config[4]'s reckoned peak {total / 1e9:.2f} GB"
                      f" against the slab rung's measured peak "
                      f"{slab_peak_gb:.2f} GB (phase 14, bench_slab_capacity "
                      f"at 124,999,680 particles)")
    zero_counts(kernel_modules)
    t0 = time.perf_counter()
    res = config4_evidence.scaled_mesh_run()
    torch.cuda.synchronize()
    if not f3.LAUNCHES:
        raise AssertionError("scaled run: no launch of B5")
    log("17 dry run", f"1/8-scale run at {res['shards']} shard: overflow "
                      f"{res['overflow']}, alive {res['alive']}, spill "
                      f"{res['spill']}, dropped {res['dropped']}, KE ratio "
                      f"{res['ke_ratio']:.6f}, B5 launches {f3.LAUNCHES}, "
                      f"{time.perf_counter() - t0:.2f} s")
    dist.destroy_process_group()
    return entries


def main() -> None:
    try:
        import torch
    except ImportError as exc:
        fail(f"torch is not importable: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import fusion_sim_torch
        from fusion_sim_torch import bench as pb
        from fusion_sim_torch import scenarios as sc
        from fusion_sim_torch.models import electromagnetic as em
        from fusion_sim_torch.models import electrostatic as es
        from fusion_sim_torch.models import pusher as pm
        from fusion_sim_torch.models import pusher_sorted as ps
        from fusion_sim_torch.models import spindle as sp
        from fusion_sim_torch.examples import mxu_experiment as mx
        from fusion_sim_torch.ops import _build
        from fusion_sim_torch.ops import analytic as an
        from fusion_sim_torch.ops import contraction_depth as cd
        from fusion_sim_torch.ops import fused_em as fe
        from fusion_sim_torch.ops import fused_em3d as fe3
        from fusion_sim_torch.ops import fused_pic as fp
        from fusion_sim_torch.ops import fused_pic3d as f3
        from fusion_sim_torch.ops import fused_pusher as fpu
        from fusion_sim_torch.ops import solvers
        from fusion_sim_torch.ops import sorted_gather as sg
        from fusion_sim_torch.ops import tile_bucket as tb
        from fusion_sim_torch.ops.sorted_deposit import (Tiling2D, Tiling3D,
                                                         build_padded_layout)
    except ImportError as exc:
        fail(f"fusion_sim_torch is not importable next to chip_smoke.py: "
             f"{exc}")
    if not os.path.abspath(fusion_sim_torch.__file__).startswith(HERE):
        fail(f"fusion_sim_torch came from {fusion_sim_torch.__file__}, not "
             f"from this checkout")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("1 card", smi)
    print(smi, flush=True)
    log("1 card", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                  f"{torch.cuda.get_device_name(0)}, count "
                  f"{torch.cuda.device_count()}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (secs, report) in built.items():
        usage = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln]
        log("2 build", f"{name}: {secs:.1f} s; " + " | ".join(usage))
    log("2 build", f"all sources in {time.perf_counter() - t0:.1f} s")

    # -- 3. kernels vs plain, small runs vs the CPU ---------------------------
    tiling = Tiling2D(tile_r=32, tile_z=32, block=1024, margin=pb.ES_MARGIN)
    phase3_es(torch, es, fp, Tiling2D, build_padded_layout, dev, tiling)
    phase3_pusher(torch, pm, ps, sc, fpu, sg, Tiling2D, dev)
    phase3_em(torch, em, fe, Tiling2D, build_padded_layout, dev)
    phase3_3d(torch, es, em, f3, fe3, Tiling3D, build_padded_layout, dev)
    phase3_card_cases()
    phase3_x1(torch, cd, dev)
    phase3_slice(torch, es, em, pm, ps, an, sc, Tiling2D, Tiling3D, dev)
    phase3_a1(torch, sp, solvers, dev)
    log("3 kernels", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 4. the ES main path ----------------------------------------------------
    kernel_modules = (fp, fpu, sg, fe, f3, fe3, cd, tb)
    b1, b1_ablations, es_resorted = phase4_es_main(torch, es, fp, smi,
                                                   kernel_modules)
    torch.cuda.empty_cache()
    log("4 ES", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 5. the pusher's fused path at full width, 5b. its pallas path --------
    b2 = phase5_fused(torch, fpu, Tiling2D, dev, smi,
                      kernel_modules)
    torch.cuda.empty_cache()
    log("5 pusher", f"done at {time.perf_counter() - t_start:.1f} s")
    b3 = phase5b_pallas(torch, sg, smi, kernel_modules)
    torch.cuda.empty_cache()
    log("5b pallas", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 6. the EM main path at full size, 6b. its pallas route -----------------
    b4, y2, t2, em_resort_rate, em2d_resorted = phase6_em_main(
        torch, em, fe, smi, kernel_modules)
    torch.cuda.empty_cache()
    log("6 EM", f"done at {time.perf_counter() - t_start:.1f} s")
    b3_em = phase6b_em_pallas(torch, sg, smi, kernel_modules)
    torch.cuda.empty_cache()
    log("6b EM pallas", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 7. the 3D ES main path, 8. the 3D EM main path, at full size ----------
    b5, es3d_resorted = phase7_es3d_main(torch, es, f3, smi,
                                         kernel_modules)
    torch.cuda.empty_cache()
    log("7 ES 3D", f"done at {time.perf_counter() - t_start:.1f} s")
    b6, y1, t1, em_resorted = phase8_em3d_main(torch, em, fe3, smi,
                                               kernel_modules)
    torch.cuda.empty_cache()
    log("8 EM 3D", f"done at {time.perf_counter() - t_start:.1f} s")
    resorts = phase8b_resort(torch, smi, {
        "ES 2D 10M": es_resorted, "EM 3D 30M": em_resorted,
        "ES 3D 30M by cell": es3d_resorted, "2D3V 10M by cell": em2d_resorted})
    torch.cuda.empty_cache()
    log("8b resort", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 9. X1 at full size, 10. the fast path, 11. the EM repair rung --------
    x1 = phase9_x1(torch, cd, mx, smi, kernel_modules)
    log("9 X1", f"done at {time.perf_counter() - t_start:.1f} s")
    phase10_fast(torch, smi)
    torch.cuda.empty_cache()
    log("10 fast", f"done at {time.perf_counter() - t_start:.1f} s")
    phase11_em_repair(torch, em, fe, smi, kernel_modules,
                      em_resort_rate)
    log("11 EM repair", f"done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()

    # -- 12. the viewer at phase 5's width ---------------------------------------
    phase12_viewer(torch, sp, fpu, smi, kernel_modules)
    log("12 viewer", f"done at {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()

    # -- 13. the bench as users run it, 14. the examples --------------------------
    phase13_bench(smi)
    log("13 bench", f"done at {time.perf_counter() - t_start:.1f} s")
    examples = phase14_examples(torch, smi, kernel_modules)
    log("14 examples", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 15. the sharded ES model in a world of one ------------------------------
    sharded = phase15_sharded(torch, es, fp, f3, Tiling2D, Tiling3D, smi,
                              kernel_modules)
    log("15 sharded", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 16. the sharded EM model, the two-axis models, in a world of one ----
    sharded += phase16_sharded(torch, em, fp, f3, fe, fe3, smi,
                               kernel_modules)
    log("16 sharded", f"done at {time.perf_counter() - t_start:.1f} s")

    # -- 17. the dry run and the config[4] evidence in a world of one --------
    dry = phase17_dryrun(torch, fp, f3, fe, fe3, smi, kernel_modules,
                         examples["bench_slab_capacity"]["res"]["peak_gb"])
    log("17 dry run", f"done at {time.perf_counter() - t_start:.1f} s")
    log("total", f"every phase passed in {time.perf_counter() - t_start:.1f}"
                 f" s")

    # B1's ablated builds ran on the main path in probe_kernel_floor
    forms = examples["probe_kernel_floor"]["b1_forms"]
    for entry in b1_ablations:
        entry["launches"] = forms.get(entry["name"].rsplit("=", 1)[1], 0)
        if not entry["launches"]:
            raise AssertionError(f"no launch of {entry['name']}")
    print(json.dumps({"kernels": [b1, *b1_ablations, b2, *b3, b4, y2, t2,
                                  b3_em, b5, b6, y1, t1, *resorts, x1,
                                  *sharded, *dry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
