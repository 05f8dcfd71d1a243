#!/usr/bin/env python3
"""Build the port's kernels and drive its main path on one CUDA card.

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero with no result):

1. card      — name and power limit (nvidia-smi), CUDA and torch versions;
2. build     — every ``fusion_sim_torch/csrc/*.cu`` with nvcc for sm_90a,
               one nvcc per source, all started together;
3. kernels   — each kernel against its plain PyTorch version on the card
               at the headline tiling (thermal and heavy-spill inputs), and
               a small model run on the card against the same run on the CPU;
4. main path — ``SortedElectrostaticPIC(backend='pallas')`` at the
               headline size (9,999,360 particles, 512^2, tile 32, margin
               10, resort every 20): one warm window, two timed windows;
               launch counts, drops, finiteness and charge are checked, then
               each kernel is timed against its plain version and its bound
               on the main path's own inputs, and one profiled window
               shows the device time by kernel and the device busy share.

The line before the last lists the kernels as JSON; the last line is the
result: ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32, outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def median_ms(torch, fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def headline_config(es, n: int, cells: int = 512):
    length = 2 * np.pi
    d = length / cells
    vol = length * length
    return es.ESConfig(grid_shape=(cells, cells), cell_size=(d, d), dt=0.05,
                       charge=-vol / n, mass=vol / n)


def compare_substep(torch, fp, args, tol_rho=1e-5, atol=1e-5):
    """Kernel vs plain on the same inputs; returns (max_abs_err, report).
    Launches made here are not part of any counted run."""
    e_grid, pos, vel, w, tid, shape, tiling, qm_dt, c_r, c_z = args
    k = fp.fused_es2d_substep(*args)
    p = fp.fused_es2d_substep_plain(*args)
    torch.cuda.synchronize()
    valid = w != 0
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


def substep_bound_ms(n_rows: int, n_valid: int, shape, block: int):
    """Least time for one substep on an H100: each row's position,
    velocity and weight read once and position, velocity and in_win
    written once, the E grid read once, rho written once, one tile id per
    block; against ~60 f32 operations per weighted row."""
    nr, nz = shape
    bytes_moved = (n_rows * (8 + 8 + 4 + 8 + 8 + 1) + nr * nz * (8 + 4)
                   + (n_rows // block) * 4)
    ops = 60 * n_valid
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), bytes_moved


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
        from fusion_sim_torch.models import electrostatic as es
        from fusion_sim_torch.ops import _build
        from fusion_sim_torch.ops import fused_pic as fp
        from fusion_sim_torch.ops.sorted_deposit import (Tiling2D,
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

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1 card] {smi}", flush=True)
    print(smi, flush=True)
    print(f"[1 card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (secs, report) in built.items():
        usage = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[2 build] {name}: {secs:.1f} s; " + " | ".join(usage),
              flush=True)
    print(f"[2 build] all sources in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 3. kernels vs plain, and a small run vs the CPU ----------------------
    shape = (512, 512)
    tiling = Tiling2D(tile_r=32, tile_z=32, block=1024, margin=10)
    rng = np.random.default_rng(1)
    n3 = 1 << 20
    cfg3 = headline_config(es, n3)
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
        print(f"[3 kernels] es2d_substep {case} ({pos_p.shape[0]} rows): "
              f"{report}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)

    n_small, cells = 16384, 64
    cfg_s = headline_config(es, n_small, cells)
    rng = np.random.default_rng(2)
    pos_s = (rng.random((n_small, 2)) * cells).astype(np.float32)
    vel_s = (0.3 * rng.standard_normal((n_small, 2))).astype(np.float32)
    kw = dict(tiling=Tiling2D(16, 16, 256, margin=2), resort_every=4,
              spill_capacity=4096, spill_tiers=(64, 512), check_spill=False,
              backend="pallas")
    cpu = es.SortedElectrostaticPIC(cfg_s, pos_s, vel_s, device="cpu", **kw)
    blob = {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in cpu.state._asdict().items() if v is not None}
    gpu = es.SortedElectrostaticPIC.from_state(cfg_s, blob, device="cuda",
                                               **kw)
    cpu.step(10)
    gpu.step(10)
    e_c, e_g = cpu.energies(), gpu.energies()
    for key in ("kinetic", "field"):
        if not math.isclose(e_g[key], e_c[key], rel_tol=1e-4):
            raise AssertionError(f"small run {key}: card {e_g[key]} vs "
                                 f"CPU {e_c[key]}")
    pc = cpu.state.position[cpu.state.valid].numpy()
    pg = gpu.state.position[gpu.state.valid].cpu().numpy()
    dmax = max(float(np.abs(np.sort(pc[:, a]) - np.sort(pg[:, a])).max())
               for a in range(2))
    if dmax > 1e-3:
        raise AssertionError(f"small run positions differ by {dmax}")
    print(f"[3 kernels] small run (16384 particles, 64^2, 10 steps, "
          f"{gpu.state.spill} spilled rows patched): card vs CPU kinetic "
          f"{e_g['kinetic']:.9g} / {e_c['kinetic']:.9g}, field "
          f"{e_g['field']:.9g} / {e_c['field']:.9g}, sorted positions "
          f"within {dmax:.3g}", flush=True)

    # -- 4. main path at the headline size ------------------------------------
    n = 10_000_000 - 10_000_000 % 1024
    cfg = headline_config(es, n)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    pos = rng.random((n, 2)).astype(np.float32) * 512
    vel = (0.05 * rng.standard_normal((n, 2))).astype(np.float32)
    resort = 20
    sim = es.SortedElectrostaticPIC(
        cfg, pos, vel, tiling=tiling, backend="pallas", resort_every=resort,
        spill_capacity=16384, spill_tiers=(1024, 4096),
        pallas_precision="exact_bf16_pack", check_spill=False)
    torch.cuda.synchronize()
    print(f"[4 main] set-up {time.perf_counter() - t0:.2f} s "
          f"({n} particles, {sim.state.position.shape[0]} layout rows)",
          flush=True)
    t0 = time.perf_counter()
    sim.step(resort)
    torch.cuda.synchronize()
    print(f"[4 main] warm window ({resort} steps + resort) "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    fp.LAUNCHES = 0
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
    print(f"[4 main] {smi}: {steps} timed steps, windows "
          f"{', '.join(f'{r:.3f}' for r in rates)} steps/s, median "
          f"{rate:.3f} steps/s = {rate * n:.4g} particle updates/s; "
          f"launches {launches}; spill patched {st.spill}, dropped "
          f"{st.spill_dropped}; charge error {rel:.3g} relative; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

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
    print(f"[4 main] es2d_substep on the main path's inputs "
          f"({st.position.shape[0]} rows): {report}; kernel {k_ms:.4f} ms "
          f"({b_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s effective), plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    solve_ms = median_ms(torch, lambda: es.solve_fields(cfg, rho))
    print(f"[4 main] solve_fields (cuFFT, 512^2) {solve_ms:.4f} ms",
          flush=True)

    # where a window's time goes: device time by kernel, device busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(resort)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and "CUDA" in str(e.device_type)]
    busy = sum(r[0] for r in rows)
    if busy > 0:
        print(f"[4 main] profiled window ({resort} steps + resort): wall "
              f"{wall_ms:.2f} ms (profiler on), device busy {busy:.2f} ms "
              f"({100 * busy / wall_ms:.1f}%), {sum(r[1] for r in rows)} "
              f"device ops", flush=True)
        for ms, count, key in sorted(rows, reverse=True)[:10]:
            print(f"[4 main]   {ms:9.3f} ms {count:5d}x {key[:90]}",
                  flush=True)
    else:
        print("[4 main] profiler recorded no device time: breakdown not "
              "measured", flush=True)

    kernels = [{
        "name": "B1:es2d_substep", "route": "cuda",
        "source": "fusion_sim_torch/csrc/es2d_substep.cu",
        "replaces": "fusion_sim_tpu/ops/pallas_pic.py:271",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
