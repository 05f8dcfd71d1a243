"""Kernels X1 and B6 of this checkout against another checkout's, on one
CUDA card, with the EM 3D main path of both.

    python -m fusion_sim_torch.examples.kernel_pair --other DIR \\
        [--ablate] [--em3d-path]

``DIR`` holds another commit's ``fusion_sim_torch/`` (and, for
``--em3d-path``, its ``chip_smoke.py``): for example the parent commit,
unpacked with ``git archive <commit> fusion_sim_torch chip_smoke.py | tar
-x -C DIR`` into a directory that ``.gitignore`` lists.  Its kernel sources
are built with this checkout's nvcc flags into ``DIR/fusion_sim_torch/
build/``.  Every pair is timed in one process, in turns (other, this,
this, other), each a median of 10 launches by CUDA events:

* X1 (``contraction_depth``) over the experiment's default sweep (S 305,
  G 32, m 96, p 1024; both orders, both precisions, K 24 .. 128), this
  checkout's output held against the plain version;
* B6 (``em3d_substep``) on the EM 3D main path's layout (29,997,056
  particles on 128^3, ``Tiling3D((8, 8, 8), 512, margin=2)``, velocities
  0.05 N(0, 1), a seeded E|B table of scale 0.01), held against the plain
  version bit for bit on positions, velocities and in_win;
* ``--ablate``: B6 of both checkouts rebuilt with its corner reads
  replaced by constants ("no gather") and with its deposit switched off
  ("no deposit"), timed on the same inputs: what each part costs;
* ``--em3d-path``: ``chip_smoke.py``'s phase 8 (the EM 3D main path,
  steps/s and B6 on the path's own inputs) of each checkout in its own
  process, other, this, this, other.

Prints one line a measurement, the card's name and power limit first.
Imports nothing of JAX; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import contraction_depth as cd
from ..ops import fused_em3d as fe3
from ..ops.sorted_deposit import Tiling3D, build_padded_layout

ROOT = _build.PACKAGE.parent
DEPTHS = (24, 32, 48, 96, 128)
# source edits of B6 for --ablate: (name, [(text, replacement), ...]); each
# edit must change the source
ABLATIONS = (
    ("no gather", [
        ("v[a][bb][d] = __ldg(q[a][bb][d] + c);",
         "v[a][bb][d] = make_float2(1e-3f * (a + bb + d + c), 0.0f);"),
        ("v[a][bb][d] = *src;",
         "v[a][bb][d] = make_float2(1e-3f * (a + bb + d + c), 0.0f);")]),
    ("no deposit", [
        ("if (inw && valid[row]) {",
         "if (inw && valid[row] && p.n_tiles < 0) {")]),
)
PHASE8 = r'''
import json, subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from fusion_sim_torch.models import electromagnetic as em
from fusion_sim_torch.ops import fused_em3d as fe3
from fusion_sim_torch.ops.sorted_deposit import Tiling3D
torch.backends.cuda.matmul.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
rec = cs.phase8_em3d_main(torch, em, fe3, Tiling3D, smi, (fe3,))
print("B6 on the path's inputs", json.dumps(rec), flush=True)
'''


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warm: int = 2) -> float:
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


def in_turns(other, this):
    """(other ms, this ms): other, this, this, other; each the mean of its
    two medians."""
    o1, t1, t2, o2 = (median_ms(other), median_ms(this), median_ms(this),
                      median_ms(other))
    return (o1 + o2) / 2, (t1 + t2) / 2


def build(sources: dict[str, Path], out_dir: Path) -> dict[str, ctypes.CDLL]:
    """nvcc every source at once with the port's flags; the loaded
    libraries by name."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources.items():
        so = out_dir / f"lib{re.sub(r'\W+', '_', name)}.so"
        jobs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def ablated_sources(src: Path, out_dir: Path, tag: str) -> dict[str, Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    out = {}
    for name, edits in ABLATIONS:
        edited = text
        for old, new in edits:
            edited = edited.replace(old, new)
        if edited == text:
            raise RuntimeError(f"ablation {name!r} changes nothing in {src}")
        path = out_dir / f"em3d_{tag}_{name.replace(' ', '_')}.cu"
        path.write_text(edited)
        out[f"{tag}: {name}"] = path
    return out


def x1_pairs(other) -> None:
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    other.contraction_depth.argtypes = [p_] * 3 + [i_] * 7 + [p_]
    other.contraction_depth.restype = i_
    s, g, m, p = 305, 32, 96, 1024
    dev = torch.device("cuda")
    for order in cd.ORDERS:
        for precision in cd.PRECISIONS:
            for k in DEPTHS:
                gen = torch.Generator(device=dev).manual_seed(k)
                a_shape = (s, g, m, k) if order == "lhs_k_lanes" \
                    else (s, g, k, m)
                a = torch.randn(a_shape, generator=gen, device=dev)
                b = torch.randn((s, g, k, p), generator=gen, device=dev)
                got = cd.contraction_depth(a, b, order, precision)
                plain = cd.contraction_depth_plain(a, b, order, precision)
                scale = cd.contraction_depth_plain(a.abs(), b.abs(), order,
                                                   "highest")
                worst = float(((got - plain).abs() / scale).max())
                tol = 1e-5 if precision == "highest" else 1e-4
                if not worst <= tol:
                    raise AssertionError(f"X1 {order} {precision} K {k}: "
                                         f"{worst} of sum|a||b| > {tol}")
                o_out = torch.empty((s, 1, p), device=dev)
                args = (s, g, m, k, p, int(precision == "default"),
                        int(order != "lhs_k_lanes"))

                def run_other():
                    err = other.contraction_depth(
                        a.data_ptr(), b.data_ptr(), o_out.data_ptr(), *args,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"other X1 launch failed: {err}")

                o_ms, t_ms = in_turns(
                    run_other,
                    lambda: cd.contraction_depth(a, b, order, precision))
                bound = 4 * (s * g * (m * k + k * p) + s * p) / 3.35e12 * 1e3
                log(f"X1 {order} {precision} K {k}: other {o_ms:.4f} ms, "
                    f"this {t_ms:.4f} ms ({o_ms / t_ms:.2f}x), byte bound "
                    f"{bound:.4f} ms ({100 * bound / o_ms:.1f}% / "
                    f"{100 * bound / t_ms:.1f}%); this vs plain {worst:.2g} "
                    f"of sum|a||b|")
                del a, b, got, plain, scale, o_out
                torch.cuda.empty_cache()


def em3d_inputs(n: int = 29_997_056, cells: int = 128):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    pos = torch.tensor((rng.random((n, 3)) * cells).astype(np.float32),
                       device=dev)
    vel = torch.tensor((0.05 * rng.standard_normal((n, 3))).astype(
        np.float32), device=dev)
    tiling = Tiling3D((8, 8, 8), 512, margin=2)
    shape = (cells,) * 3
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        pos, shape, tiling, vel[:, 0], vel[:, 1], vel[:, 2],
        derive_valid=True)
    del pos, vel
    table = (0.01 * torch.randn((*shape, 6), device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(1)))
    # cell 0.5, dt 0.1, charge -0.01, mass 0.01: chip_smoke's em3d_config
    return (table, pos_p.contiguous(),
            torch.stack([v0, v1, v2], -1).contiguous(), valid, tid, shape,
            tiling, -0.05, 0.1, (0.5, 0.5, 0.5), -0.01)


def em3d_launcher(lib, args):
    """A closure launching ``lib``'s em3d_substep on ``args`` (the C
    interface every checkout's B6 shares)."""
    table, pos, vel, valid, tid, shape, tiling = args[:7]
    nts, n_tiles, k = fe3._constants(shape, tiling, pos, *args[7:11], 1.0)
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.em3d_substep.argtypes = [p_] * 9 + [i_] * 13 + [f_] * 10 + [p_]
    lib.em3d_substep.restype = i_
    pos_out, vel_out = torch.empty_like(pos), torch.empty_like(vel)
    j = torch.zeros((*shape, 3), device=pos.device)
    in_win = torch.empty(pos.shape[0], dtype=torch.bool, device=pos.device)

    def run():
        j.zero_()
        err = lib.em3d_substep(
            table.data_ptr(), pos.data_ptr(), vel.data_ptr(),
            valid.data_ptr(), tid.data_ptr(), pos_out.data_ptr(),
            vel_out.data_ptr(), j.data_ptr(), in_win.data_ptr(),
            pos.shape[0], tiling.block, *shape, nts[1], nts[2], n_tiles,
            *tiling.tile, tiling.margin, 0, k["qm_half_dt"], k["dt"],
            k["inv_dx"], k["inv_dy"], k["inv_dz"], k["coef_x"], k["coef_y"],
            k["coef_z"], k["inv_c2"], k["charge"],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"em3d_substep launch failed: {err}")
    return run


def b6_pairs(other, ablations) -> None:
    args = em3d_inputs()
    got = fe3.fused_em3d_substep(*args)
    plain = fe3.fused_em3d_substep_plain(*args)
    torch.cuda.synchronize()
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        if not bool(torch.equal(got[i], plain[i])):
            raise AssertionError(f"B6 {name} differs from the plain version")
    err = float((got[2] - plain[2]).abs().max())
    scale = float(plain[2].abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"B6 J differs: {err} > 1e-5 * {scale}")
    del got, plain
    this = lambda: fe3.fused_em3d_substep(*args)  # noqa: E731
    o_ms, t_ms = in_turns(em3d_launcher(other, args), this)
    log(f"B6 ({args[1].shape[0]} rows): other {o_ms:.4f} ms, this "
        f"{t_ms:.4f} ms ({o_ms / t_ms:.2f}x); this vs plain: positions, "
        f"velocities and in_win equal, J within {err / scale:.2g} of max|J|")
    for name, lib in ablations.items():
        log(f"B6 {name}: {median_ms(em3d_launcher(lib, args)):.4f} ms")


def em3d_path(other_dir: Path) -> None:
    for label, cwd in (("other", other_dir), ("this", ROOT), ("this", ROOT),
                       ("other", other_dir)):
        out = subprocess.run([sys.executable, "-c", PHASE8], cwd=cwd,
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if "steps/s" in line or "on the main path's inputs" in line \
                    or line.startswith("B6 "):
                log(f"EM 3D path, {label}: {line}")
        if out.returncode:
            raise RuntimeError(f"phase 8 of {cwd} failed:\n{out.stderr}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="a directory holding another commit's "
                         "fusion_sim_torch/")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--em3d-path", action="store_true")
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_pair needs a CUDA card")
    other_dir = ns.other.resolve()
    other_csrc = other_dir / "fusion_sim_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_all()
    sources = {"other_x1": other_csrc / "contraction_depth.cu",
               "other_b6": other_csrc / "em3d_substep.cu"}
    ablate_dir = _build.BUILD / "ablate"
    if ns.ablate:
        sources.update(ablated_sources(_build.CSRC / "em3d_substep.cu",
                                       ablate_dir, "this"))
        sources.update(ablated_sources(other_csrc / "em3d_substep.cu",
                                       ablate_dir, "other"))
    libs = build(sources, other_dir / "fusion_sim_torch" / "build")
    x1_pairs(libs.pop("other_x1"))
    b6_pairs(libs.pop("other_b6"), libs)
    if ns.em3d_path:
        em3d_path(other_dir)


if __name__ == "__main__":
    main()
