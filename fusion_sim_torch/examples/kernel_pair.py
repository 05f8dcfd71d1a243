"""This checkout's kernels against another checkout's, on one CUDA card,
with the main paths of both.

    python -m fusion_sim_torch.examples.kernel_pair --other DIR \\
        [--kernels b4,b5,b3,b6,x1,y1,t1] [--ablate] [--em2d-path] \\
        [--es3d-path] [--em3d-path] [--pusher-path] [--em-pallas-path] \\
        [--resort-path]

``DIR`` holds another commit's ``fusion_sim_torch/`` and ``chip_smoke.py``:
for example the parent commit, unpacked with ``git archive <commit>
fusion_sim_torch chip_smoke.py | tar -x -C DIR`` into a directory that
``.gitignore`` lists.  Its kernel sources are built with this checkout's
nvcc flags into ``DIR/fusion_sim_torch/build/``.  Every pair is timed in
one process, in turns (other, this, this, other), each a median of 10
launches by CUDA events, on the inputs of the main path that runs the
kernel; both checkouts' kernels are launched alike, through their C
interface (which both keep) into outputs allocated once, so that the
wrapper's host work is in neither time:

* B4 (``em2d_substep``) on the inputs of both EM 2D rungs: the resort-12
  rung (``chip_smoke.py`` phase 6: 10,002,432 particles on 512^2,
  ``Tiling2D(32, 32, 1024, margin=6)``) 6 steps into a window and the
  repair rung (phase 11: ``Tiling2D(16, 16, 1024, margin=7)``,
  ``repair=True``) after its warm window of 12 steps, E|B centered from
  the state; each rung with its layout built by tile (rows in no order
  inside a tile) and by cell inside each tile, as a shell that built and
  resorted by cell would hold it; this checkout's output held against
  the plain version bit for bit on positions, velocities and in_win; and
  the 2D resort (``build_padded_layout``) of the resort-12 rung by tile
  and by cell;
* B5 (``es3d_substep``): the ES 3D main path (29,997,056 particles on
  128^3, ``Tiling3D((8, 8, 8), 512, margin=2)``, ``chip_smoke.py``'s
  configuration) 3 steps into a window, E solved from its rho; both
  kernels on the rows ordered by cell inside each tile (the ES 3D shell's
  layout) and on the same rows ordered by tile only, in no order inside a
  tile (the parent's layout); this checkout's output
  held against the plain version bit for bit on positions, velocities and
  in_win; and the resort (``build_padded_layout``) by tile and by cell;
* B3 (``gather2d``) in each form on its path's inputs: nearest with 12
  channels (the pusher's field rows) and with 1 (its sink mask) on the
  pallas pusher at 1,048,576 protons after one window, cic with 6 channels
  on the EM pallas route at 1,048,576 particles after one window; this
  checkout's output held against the plain version bit for bit;
* B6 (``em3d_substep``) on the EM 3D main path's layout (the same
  particles, a seeded E|B table of scale 0.01), held against the plain
  version bit for bit, and this checkout's B6 on the rows ordered by cell;
* X1 (``contraction_depth``) over the experiment's default sweep (S 305,
  G 32, m 96, p 1024; both orders, both precisions, K 24 .. 128);
* Y1 (``yee3d``) at 128^3 (seeded E, B and J of scale 0.01): the plain
  Yee update (``ops/yee3d.yee_update_3d_plain``, the rolls and differences
  of ``ops/fdtd.py``), which is what the other checkout runs where it has
  no ``csrc/yee3d.cu`` and the same ``ops/fdtd.py``, against this
  checkout's kernel, held bit for bit, beside its byte bound (60 B a
  cell);
* T1 (``node_table3d``) at 128^3 (seeded E and B of scale 0.01): the
  plain node table (``ops/fdtd.center_fields`` with the 3D offsets), which
  is what the other checkout's 3D shells build where it has no
  ``csrc/node_table3d.cu`` and the same ``ops/fdtd.py``, against this
  checkout's kernel, held bit for bit, beside its byte bound (48 B a
  node);
* ``--ablate``: B4, B5 and B6 of both checkouts rebuilt with their
  corner reads replaced by constants ("no gather") and with their deposit
  switched off ("no deposit"), B4 of both also with its J flush switched
  off ("no flush"), and this checkout's B3 with its grid reads replaced by
  zeros ("no grid read"), timed on the same inputs: what each part costs;
  and this checkout's B4 rebuilt with 256, 512 and 1024 threads a CTA
  whatever the window, without the in-cell rows' shared adds ("no shared
  adds") and with each row a group of its own ("no combine"):
  ``B4_VARIANTS``;
* ``--em2d-path``: ``chip_smoke.py``'s phases 6 (the EM 2D main path) and
  11 (its repair rung) of each checkout in its own process, other, this,
  this, other: steps/s and B4 on each rung's own inputs;
* ``--es3d-path``, ``--em3d-path``, ``--pusher-path``,
  ``--em-pallas-path``: ``chip_smoke.py``'s phase 7 (ES 3D), 8 (EM 3D),
  5b (the pallas pusher) or 6b (the EM pallas route) of each checkout in
  its own process, other, this, this, other: steps/s and the kernel on the
  path's own inputs; ``--resort-path``: each checkout's 3D resort
  (``build_padded_layout``) on the ES 3D path's state after a window, by
  tile and, in a checkout that has it, by cell (the EM 3D shell's resort
  is the same call by tile).

Prints one line a measurement, the card's name and power limit first.
Imports nothing of JAX; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import _build
from ..ops import contraction_depth as cd
from ..ops import fused_em as fe
from ..ops import fused_em3d as fe3
from ..ops import fused_pic3d as f3
from ..ops import node_table3d as nt
from ..ops import sorted_gather as sg
from ..ops import yee3d as y3
from ..ops.sorted_deposit import Tiling3D, build_padded_layout

ROOT = _build.PACKAGE.parent
DEPTHS = (24, 32, 48, 96, 128)
KERNELS = ("b4", "b5", "b3", "b6", "x1", "y1", "t1")
# source edits for --ablate, by source: (name, [(text, replacement), ...]);
# the edits cover this checkout's source and its parent's, and each
# ablation must change the source it is applied to
ABLATIONS = {
    "em2d_substep": (
        ("no gather", [
            ("return *q;", "return make_float2(1e-3f, 2e-3f);"),
            ("return __ldg(q);", "return make_float2(1e-3f, 2e-3f);"),
            ("const float2 w00 = __ldg(c00 + c), w10 = __ldg(c10 + c);",
             "const float2 w00 = make_float2(1e-3f, 2e-3f), w10 = w00;"),
            ("const float2 w01 = __ldg(c01 + c), w11 = __ldg(c11 + c);",
             "const float2 w01 = w00, w11 = w00;")]),
        ("no deposit", [
            ("const bool dep = inw && cur[5] != 0.0f;",
             "const bool dep = inw && cur[5] != 0.0f && p.n_tiles < 0;"),
            ("if (inw && valid[row]) {",
             "if (inw && valid[row] && p.n_tiles < 0) {")]),
        ("no flush", [
            ("if (val != 0.0f) add_to_grid(j_grid, k, val, wz, otr, otz, nr, "
             "nz);",
             "if (val != 0.0f && p.n_tiles < 0) "
             "add_to_grid(j_grid, k, val, wz, otr, otz, nr, nz);"),
            ("flush_window(j_s, j_grid, wn3, wz, otr, otz, nr, nz);",
             "if (p.n_tiles < 0) "
             "flush_window(j_s, j_grid, wn3, wz, otr, otz, nr, nz);")]),
    ),
    "em3d_substep": (
        ("no gather", [
            ("v[a][bb][d] = __ldg(q[a][bb][d] + c);",
             "v[a][bb][d] = make_float2(1e-3f * (a + bb + d + c), 0.0f);"),
            ("v[a][bb][d] = *src;",
             "v[a][bb][d] = make_float2(1e-3f * (a + bb + d + c), 0.0f);")]),
        ("no deposit", [
            ("if (inw && valid[row]) {",
             "if (inw && valid[row] && p.n_tiles < 0) {"),
            ("if (inw && live) {", "if (inw && live && p.n_tiles < 0) {")]),
    ),
    "es3d_substep": (
        ("no gather", [
            ("q[a] = make_float3(e[0], e[1], e[2]);",
             "q[a] = make_float3(1e-3f * a, 2e-3f, 3e-3f);"),
            ("""e0[c] = c00 * q0[c] + c01 * q0[3 + c] + c10 * q0[sy + c]
                  + c11 * q0[sy + 3 + c];""", "e0[c] = 1e-3f * (c + 1);"),
            ("""e1[c] = c00 * q1[c] + c01 * q1[3 + c] + c10 * q1[sy + c]
                  + c11 * q1[sy + 3 + c];""", "e1[c] = 2e-3f * (c + 1);")]),
        ("no deposit", [
            ("if (__any_sync(kFull, dep)) {",
             "if (__any_sync(kFull, dep) && p.n_tiles < 0) {"),
            ("      if (inw && valid) {",
             "      if (inw && valid && p.n_tiles < 0) {")]),
    ),
    # this checkout's B3 only
    "gather2d": (
        ("no grid read", [
            ("namespace {\n", "namespace {\ntemplate <class T>\n"
             "__device__ T ldg0(const T*) { return T{}; }\n"),
            ("__ldg(", "ldg0(")]),
    ),
}
# source edits of this checkout's B4 for --ablate: its threads a CTA,
# whatever the window, and the parts of its combined in-cell deposit
B4_VARIANTS = (
    ("256 threads a CTA", [
        ("if (cta_threads(tile_r + 2 * margin + 1, tile_z + 2 * margin + 1) "
         "== 256) {", "if (true) {")]),
    ("512 threads a CTA", [
        ("if (cta_threads(tile_r + 2 * margin + 1, tile_z + 2 * margin + 1) "
         "== 256) {", "if (false) {")]),
    ("1024 threads a CTA", [
        ("if (cta_threads(tile_r + 2 * margin + 1, tile_z + 2 * margin + 1) "
         "== 256) {", "if (false) {"),
        ("return launch_form<512>(", "return launch_form<1024>(")]),
    ("no shared adds", [
        ("if (in_cell && lane == __ffs(peers) - 1) {",
         "if (in_cell && lane == __ffs(peers) - 1 && p.n_tiles < 0) {")]),
    ("no combine", [
        ("const unsigned peers = __match_any_sync(kFull, key);",
         "const unsigned peers = 1u << lane;")]),
)
# chip_smoke.py's phase of a path, run in the checkout's own directory
PATH_RUN = r'''
import json, subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from fusion_sim_torch import scenarios as sc
from fusion_sim_torch.models import electromagnetic as em
from fusion_sim_torch.models import electrostatic as es
from fusion_sim_torch.models import pusher as pm
from fusion_sim_torch.ops import fused_em as fe
from fusion_sim_torch.ops import fused_em3d as fe3
from fusion_sim_torch.ops import fused_pic3d as f3
from fusion_sim_torch.ops import sorted_gather as sg
from fusion_sim_torch.ops import tile_bucket as tb
from fusion_sim_torch.ops.sorted_deposit import Tiling2D, Tiling3D
torch.backends.cuda.matmul.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
mods = kernel_modules = (fe, fe3, f3, sg, tb)


def call(fn, **extra):
    """A phase of this checkout's chip_smoke.py with its arguments by
    name, so that checkouts with other phase signatures run alike."""
    import inspect
    names = dict(globals(), **extra)
    return fn(**{p: names[p] for p in inspect.signature(fn).parameters
                 if p in names})


rec = {call}
print("kernel record", json.dumps(rec), flush=True)
'''
# the 3D resort of a checkout: its build_padded_layout on the ES 3D path's
# state after a window (the EM 3D shell's resort is the same call), by tile
# and, where the checkout has it, by cell
RESORT = r'''
def resorts():
    import inspect
    import numpy as np
    from fusion_sim_torch.ops.sorted_deposit import build_padded_layout
    try:
        from fusion_sim_torch.examples import bench_3d
        sim = bench_3d.build_sim("es", "pallas")
    except ImportError:       # a checkout whose chip_smoke.py holds the rung
        sim = es.SortedElectrostaticPIC(
            cs.es3d_config(es, cs.N_3D), *cs.rung_3d_particles(cs.N_3D),
            tiling=Tiling3D(**cs.TILING_3D), backend="pallas",
            resort_every=6, check_spill=False)
    cfg, tiling = sim.config, sim.tiling
    sim.step(6)
    st = sim.state
    out = {}
    for order in ((False, True) if "cell_order" in inspect.signature(
            build_padded_layout).parameters else (None,)):
        kw = {} if order is None else {"cell_order": order}
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            build_padded_layout(st.position, cfg.grid_shape, tiling,
                                *st.velocity.unbind(-1), valid=st.valid,
                                derive_valid=True, **kw)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        key = "by cell" if order else "by tile"
        out[key] = float(np.median(times[2:]))
        print(f"resort inputs: {st.position.shape[0]} rows, {key} "
              f"{out[key]:.4f} ms", flush=True)
    return out
'''
PATHS = {
    "em2d": "(lambda r6: [r6, call(cs.phase11_em_repair, "
            "resort_rate=r6[1])])(call(cs.phase6_em_main))",
    "es3d": "call(cs.phase7_es3d_main)",
    "em3d": "call(cs.phase8_em3d_main)",
    "pusher": "call(cs.phase5b_pallas)",
    "em-pallas": "call(cs.phase6b_em_pallas)",
    "resort": "resorts()",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warm: int = 2, device=None) -> float:
    """Median device time of ``fn`` (CUDA events), each run queued behind
    ~0.5 ms of device sleep so that the host's launch work stays out.  On
    ``device="cpu"`` (the examples' ``--device cpu``) the median host time
    of a call instead: the CPU's figure, not the card's."""
    for _ in range(warm):
        fn()
    if device is not None and torch.device(device).type == "cpu":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
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


def ablated_sources(src: Path, out_dir: Path, tag: str,
                    variants=None) -> dict[str, Path]:
    """``src`` with each of ``variants`` (ABLATIONS of its stem by
    default) applied, by name."""
    out_dir.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    out = {}
    for name, edits in variants or ABLATIONS[src.stem]:
        edited = text
        for old, new in edits:
            edited = edited.replace(old, new)
        if edited == text:
            raise RuntimeError(f"ablation {name!r} changes nothing in {src}")
        path = out_dir / f"{src.stem}_{tag}_{name.replace(' ', '_')}.cu"
        path.write_text(edited)
        out[f"{src.stem} {tag}: {name}"] = path
    return out


def smoke():
    """This checkout's chip_smoke.py as a module (its configurations)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def check_fused(label, got, plain):
    """A fused substep against its plain version: positions, velocities
    and in_win bit for bit, the deposited grid within 1e-5 of its max;
    returns the grid's error relative to its max."""
    torch.cuda.synchronize()
    for name, i in (("position", 0), ("velocity", 1), ("in_win", 3)):
        if not bool(torch.equal(got[i], plain[i])):
            raise AssertionError(f"{label} {name} differs from the plain "
                                 f"version")
    err = float((got[2] - plain[2]).abs().max())
    scale = float(plain[2].abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"{label}: grid differs: {err} > 1e-5 * "
                             f"{scale}")
    return err / scale


# -- X1 -------------------------------------------------------------------------

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


# -- Y1 -------------------------------------------------------------------------

def y1_pairs(other_dir: Path) -> None:
    same = ((other_dir / "fusion_sim_torch/ops/fdtd.py").read_bytes()
            == (_build.PACKAGE / "ops/fdtd.py").read_bytes())
    has_kernel = (other_dir / "fusion_sim_torch/csrc/yee3d.cu").exists()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    shape = (128, 128, 128)
    e, b, j = (0.01 * torch.randn((*shape, 3), generator=gen, device=dev)
               for _ in range(3))
    args = (e, b, j, 0.1, (0.5, 0.5, 0.5), 1.0, 1.0)
    got, plain = y3.yee_update_3d(*args), y3.yee_update_3d_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
        raise AssertionError("Y1 differs from the plain Yee update")
    del got, plain
    p_ms, t_ms = in_turns(lambda: y3.yee_update_3d_plain(*args),
                          lambda: y3.yee_update_3d(*args))
    bound = math.prod(shape) * 5 * 12 / 3.35e12 * 1e3
    log(f"Y1 (128^3): plain (the other checkout's Yee update: "
        f"{'its own kernel' if has_kernel else 'no kernel'}, ops/fdtd.py "
        f"{'the same' if same else 'another'}) {p_ms:.4f} ms, this "
        f"{t_ms:.4f} ms ({p_ms / t_ms:.2f}x); byte bound {bound:.4f} ms "
        f"({100 * bound / p_ms:.1f}% / {100 * bound / t_ms:.1f}%); this vs "
        f"plain: E and B equal")
    del e, b, j, args
    torch.cuda.empty_cache()


# -- T1 -------------------------------------------------------------------------

def t1_pairs(other_dir: Path) -> None:
    same = ((other_dir / "fusion_sim_torch/ops/fdtd.py").read_bytes()
            == (_build.PACKAGE / "ops/fdtd.py").read_bytes())
    has_kernel = (other_dir
                  / "fusion_sim_torch/csrc/node_table3d.cu").exists()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    shape = (128, 128, 128)
    e, b = (0.01 * torch.randn((*shape, 3), generator=gen, device=dev)
            for _ in range(2))
    got, plain = nt.node_table_3d(e, b), nt.node_table_3d_plain(e, b)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        raise AssertionError("T1 differs from the plain node table")
    del got, plain
    p_ms, t_ms = in_turns(lambda: nt.node_table_3d_plain(e, b),
                          lambda: nt.node_table_3d(e, b))
    bound = math.prod(shape) * 48 / 3.35e12 * 1e3
    log(f"T1 (128^3): plain (the other checkout's node table: "
        f"{'its own kernel' if has_kernel else 'no kernel'}, ops/fdtd.py "
        f"{'the same' if same else 'another'}) {p_ms:.4f} ms, this "
        f"{t_ms:.4f} ms ({p_ms / t_ms:.2f}x); byte bound {bound:.4f} ms "
        f"({100 * bound / p_ms:.1f}% / {100 * bound / t_ms:.1f}%); this vs "
        f"plain: the table equal")
    del e, b
    torch.cuda.empty_cache()


# -- B6 -------------------------------------------------------------------------

def em3d_inputs(n: int = 29_997_056, cells: int = 128,
                cell_order: bool = False):
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
        derive_valid=True, cell_order=cell_order)
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
    err = check_fused("B6", fe3.fused_em3d_substep(*args),
                      fe3.fused_em3d_substep_plain(*args))
    this = fe3._library()
    o_ms, t_ms = in_turns(em3d_launcher(other, args),
                          em3d_launcher(this, args))
    log(f"B6 ({args[1].shape[0]} rows): other {o_ms:.4f} ms, this "
        f"{t_ms:.4f} ms ({o_ms / t_ms:.2f}x); this vs plain: positions, "
        f"velocities and in_win equal, J within {err:.2g} of max|J|")
    for name, lib in ablations.items():
        log(f"B6 {name}: {median_ms(em3d_launcher(lib, args)):.4f} ms")
    tile = em3d_launcher(this, args)
    cell = em3d_launcher(this, em3d_inputs(cell_order=True))
    tile_ms, cell_ms = in_turns(tile, cell)
    log(f"B6 of this checkout, rows by tile {tile_ms:.4f} ms, the same rows "
        f"by cell inside each tile {cell_ms:.4f} ms")
    del args, tile, cell
    torch.cuda.empty_cache()


# -- B4 -------------------------------------------------------------------------

def relayout(sim, cell_order: bool) -> None:
    """A 2D EM model's layout rebuilt from its state as its resort builds
    it, by cell inside each tile, or by tile from the rows in a random
    order (so each tile's rows come in no order, as the parent's shell
    holds them)."""
    s = sim.state
    n_state = s.position.shape[0]
    if not cell_order:
        perm = torch.randperm(n_state, device=s.position.device,
                              generator=torch.Generator(
                                  device=s.position.device).manual_seed(3))
        s = s._replace(position=s.position[perm], velocity=s.velocity[perm],
                       valid=s.valid[perm])
    tid, pos_p, v0, v1, v2, valid_p, _ = build_padded_layout(
        s.position, sim.config.grid_shape, sim.tiling,
        *s.velocity.unbind(-1), valid=s.valid, reserve=sim.repair,
        spread=sim.repair, derive_valid=True, cell_order=cell_order)
    sim.state = s._replace(
        position=pos_p[:n_state].contiguous(),
        velocity=torch.stack([v0, v1, v2], -1)[:n_state].contiguous(),
        tile_id=tid[:n_state], valid=valid_p[:n_state])
    if sim.repair:
        sim._rebuild_free_list()


def em2d_inputs(cs, rung: str, cell_order: bool):
    """B4's arguments on an EM 2D rung's own state, and the model:
    'resort-12' (phase 6) 6 steps into a window, 'repair' (phase 11)
    after its warm window of 12 steps; the layout built by tile or by
    cell."""
    from ..ops import fdtd
    from . import bench_em_fused

    if rung == "repair":
        sim = bench_em_fused.build_sim(tile=16, margin=7, backend="fused",
                                       repair=True)
    else:
        sim = bench_em_fused.build_sim(backend="fused")
    relayout(sim, cell_order)
    sim.step(12 if rung == "repair" else 6)
    st = sim.state
    table = fdtd.center_fields(st.e, st.b, fdtd.E_OFFSETS_2D,
                               fdtd.B_OFFSETS_2D)
    return cs.em_substep_args(sim.config, sim.tiling, table, st), sim


def em2d_launcher(lib, args):
    """A closure launching ``lib``'s em2d_substep on ``args`` (the C
    interface every checkout's B4 shares)."""
    table, pos, vel, valid, tid, shape, tiling = args[:7]
    nr, nz, ntz, n_tiles, k = fe._constants(shape, tiling, pos, *args[7:11],
                                            1.0)
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.em2d_substep.argtypes = [p_] * 9 + [i_] * 10 + [f_] * 9 + [p_]
    lib.em2d_substep.restype = i_
    pos_out, vel_out = torch.empty_like(pos), torch.empty_like(vel)
    j = torch.zeros((nr, nz, 3), device=pos.device)
    in_win = torch.empty(pos.shape[0], dtype=torch.bool, device=pos.device)

    def run():
        j.zero_()
        a = (table.data_ptr(), pos.data_ptr(), vel.data_ptr(),
             valid.data_ptr(), tid.data_ptr(), pos_out.data_ptr(),
             vel_out.data_ptr(), j.data_ptr(), in_win.data_ptr(),
             pos.shape[0], tiling.block, nr, nz, ntz, n_tiles,
             tiling.tile_r, tiling.tile_z, tiling.margin, 0,
             k["qm_half_dt"], k["dt"], k["inv_dx"], k["inv_dz"],
             k["coef_x"], k["coef_z"], k["inv_vol"], k["inv_c2"],
             k["charge"])
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.em2d_substep(*a, stream)
        if err:
            raise RuntimeError(f"em2d_substep launch failed: {err}")
    return run


def b4_pairs(other, ablations, cs) -> None:
    this = fe._library()
    for rung in ("resort-12", "repair"):
        for cell_order in (False, True):
            label = f"{rung}, rows {'by cell' if cell_order else 'by tile'}"
            args, sim = em2d_inputs(cs, rung, cell_order)
            err = check_fused(f"B4 ({label})", fe.fused_em2d_substep(*args),
                              fe.fused_em2d_substep_plain(*args))
            rows = args[1].shape[0]
            b_ms = cs.em_bound_ms(rows, sim.n_real, args[5],
                                  args[6].block)[0]
            o_ms, t_ms = in_turns(em2d_launcher(other, args),
                                  em2d_launcher(this, args))
            log(f"B4 ({label}, {rows} rows): other {o_ms:.4f} ms, this "
                f"{t_ms:.4f} ms ({o_ms / t_ms:.2f}x), bound {b_ms:.4f} ms "
                f"({100 * b_ms / o_ms:.1f}% / {100 * b_ms / t_ms:.1f}%); "
                f"this vs plain: positions, velocities and in_win equal, J "
                f"within {err:.2g} of max|J|")
            for name, lib in ablations.items():
                log(f"B4 {label}, {name}: "
                    f"{median_ms(em2d_launcher(lib, args)):.4f} ms")
            if rung == "resort-12" and not cell_order:
                st, cfg, tiling = sim.state, sim.config, sim.tiling

                def resort(order):
                    return lambda: build_padded_layout(
                        st.position, cfg.grid_shape, tiling,
                        *st.velocity.unbind(-1), valid=st.valid,
                        derive_valid=True, cell_order=order)
                tile_ms, cell_ms = in_turns(resort(False), resort(True))
                log(f"2D resort ({rows} rows): by tile {tile_ms:.4f} ms, by "
                    f"cell {cell_ms:.4f} ms")
            del args, sim
            torch.cuda.empty_cache()


# -- B5 -------------------------------------------------------------------------

def es3d_inputs(cs):
    """The ES 3D main path's state 3 steps into a window, E solved from its
    rho: (args by cell, args by tile, the model) with the shell's
    cell-ordered layout and the same rows sorted by tile from a random
    order."""
    from ..models import electrostatic as es
    from . import bench_3d

    sim = bench_3d.build_sim("es", "pallas")
    cfg, tiling = sim.config, sim.tiling
    sim.step(3)
    st = sim.state
    rho = st.rho - torch.sum(st.rho) / math.prod(cfg.grid_shape)
    _, e_grid = es.solve_fields(cfg, rho)
    by_cell = cs.es3d_substep_args(torch, cfg, tiling, e_grid, st)
    n = st.position.shape[0]
    # the parent's layout: a stable sort by tile of rows in no order (the
    # particles' own), so each tile's rows come in no order
    perm = torch.randperm(n, device=st.position.device,
                          generator=torch.Generator(
                              device=st.position.device).manual_seed(3))
    tid, pos_p, v0, v1, v2, valid, _ = build_padded_layout(
        st.position[perm], cfg.grid_shape, tiling,
        *st.velocity[perm].unbind(-1), valid=st.valid[perm],
        derive_valid=True)
    st_t = es.SortedESState(pos_p[:n].contiguous(),
                            torch.stack([v0, v1, v2], -1)[:n].contiguous(),
                            tid[:n], valid[:n], 0, 0, 0)
    by_tile = cs.es3d_substep_args(torch, cfg, tiling, e_grid, st_t)
    return by_cell, by_tile, sim


def es3d_launcher(lib, args):
    """A closure launching ``lib``'s es3d_substep on ``args`` (the C
    interface every checkout's B5 shares)."""
    e_grid, pos, vel, w, tid, shape, tiling, qm_dt, cx, cy, cz = args
    nts = tiling.n_tiles(shape)
    p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.es3d_substep.argtypes = [p_] * 9 + [i_] * 12 + [f_] * 4 + [p_]
    lib.es3d_substep.restype = i_
    pos_out, vel_out = torch.empty_like(pos), torch.empty_like(vel)
    rho = torch.zeros(shape, device=pos.device)
    in_win = torch.empty(pos.shape[0], dtype=torch.bool, device=pos.device)

    def run():
        rho.zero_()
        err = lib.es3d_substep(
            e_grid.data_ptr(), pos.data_ptr(), vel.data_ptr(), w.data_ptr(),
            tid.data_ptr(), pos_out.data_ptr(), vel_out.data_ptr(),
            rho.data_ptr(), in_win.data_ptr(), pos.shape[0], tiling.block,
            *shape, nts[1], nts[2], math.prod(nts), *tiling.tile,
            tiling.margin, qm_dt, cx, cy, cz,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"es3d_substep launch failed: {err}")
    return run


def b5_pairs(other, ablations, cs) -> None:
    by_cell, by_tile, sim = es3d_inputs(cs)
    for label, args in (("by cell", by_cell), ("by tile", by_tile)):
        err = check_fused(f"B5 ({label})", f3.fused_es3d_substep(*args),
                          f3.fused_es3d_substep_plain(*args))
        o_ms, t_ms = in_turns(es3d_launcher(other, args),
                              es3d_launcher(f3._library(), args))
        log(f"B5 ({args[1].shape[0]} rows {label}): other {o_ms:.4f} ms, "
            f"this {t_ms:.4f} ms ({o_ms / t_ms:.2f}x); this vs plain: "
            f"positions, velocities and in_win equal, rho within {err:.2g} "
            f"of max|rho|")
        for name, lib in ablations.items():
            log(f"B5 {label}, {name}: "
                f"{median_ms(es3d_launcher(lib, args)):.4f} ms")
    # the resort: the layout rebuilt from the path's state, by tile and by
    # cell inside each tile
    st = sim.state
    cfg, tiling = sim.config, sim.tiling

    def resort(cell_order):
        return lambda: build_padded_layout(
            st.position, cfg.grid_shape, tiling, *st.velocity.unbind(-1),
            valid=st.valid, derive_valid=True, cell_order=cell_order)
    tile_ms, cell_ms = in_turns(resort(False), resort(True))
    log(f"resort ({st.position.shape[0]} rows): by tile {tile_ms:.4f} ms, "
        f"by cell {cell_ms:.4f} ms")
    del by_cell, by_tile, sim, st
    torch.cuda.empty_cache()


# -- B3 -------------------------------------------------------------------------

def gather_launcher(lib, args):
    """A closure launching ``lib``'s gather2d on ``args`` (the C interface
    every checkout's B3 shares)."""
    grid, pos, tid, shape, tiling, mode = args
    n_c = grid[0, 0].numel()
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.gather2d.argtypes = [p_] * 5 + [i_] * 10 + [p_]
    lib.gather2d.restype = i_
    out = torch.empty((pos.shape[0], n_c), device=pos.device)
    in_win = torch.empty(pos.shape[0], dtype=torch.bool, device=pos.device)

    def run():
        err = lib.gather2d(
            grid.data_ptr(), pos.data_ptr(), tid.data_ptr(), out.data_ptr(),
            in_win.data_ptr(), pos.shape[0], n_c, tiling.block, *shape,
            tiling.n_tiles(shape)[1], tiling.tile_r, tiling.tile_z,
            tiling.margin, int(mode == "cic"),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gather2d launch failed: {err}")
    return run


def b3_inputs():
    """Each form of B3 on its path's inputs: [(label, args, valid)]."""
    from ..bench import build_sorted_sim
    from ..ops import fdtd
    from ..ops.boris import pack_coefficients
    from ..ops.fused_pusher import cell_coords
    from . import bench_em_fused

    # chip_smoke.py phase 5b's rung
    sim = build_sorted_sim(1024, resort_every=12, spill_capacity=32768,
                           respawn_capacity=512, backend="pallas")
    sim.step(12)
    st, tiling, shape = sim._sorted_state, sim._sorted_tiling, (400, 800)
    cell = cell_coords(st.position, *shape)
    forms = [("nearest C=12 (pusher)",
              (pack_coefficients(sim.fields.coeffs), cell, st.tile_id, shape,
               tiling, "nearest"), st.valid),
             ("nearest C=1 (pusher sink)",
              (sim.fields.sink_mask[..., None].contiguous(), cell,
               st.tile_id, shape, tiling, "nearest"), st.valid)]
    em_sim = bench_em_fused.build_sim(1 << 20, backend="pallas")
    em_sim.step(12)
    s = em_sim.state
    table = fdtd.center_fields(s.e, s.b, fdtd.E_OFFSETS_2D, fdtd.B_OFFSETS_2D)
    forms.append(("cic C=6 (EM route)",
                  (table, s.position, s.tile_id, em_sim.config.grid_shape,
                   em_sim.tiling, "cic"), s.valid))
    return forms


def b3_pairs(other, ablations, cs) -> None:
    for label, args, valid in b3_inputs():
        got = sg.gather_sorted_2d_window(*args)
        plain = sg.gather_sorted_2d_window_plain(*args)
        if not (bool(torch.equal(got[1], plain[1]))
                and bool(torch.equal(got[0][valid], plain[0][valid]))):
            raise AssertionError(f"B3 {label} differs from the plain version")
        del got, plain
        o_ms, t_ms = in_turns(gather_launcher(other, args),
                              gather_launcher(sg._library(), args))
        n_c = args[0][0, 0].numel()
        b_ms = cs.gather_bound_ms(args[1].shape[0], n_c, args[3],
                                  args[4].block, args[5])[0]
        log(f"B3 {label} ({args[1].shape[0]} rows): other {o_ms:.4f} ms, "
            f"this {t_ms:.4f} ms ({o_ms / t_ms:.2f}x), bound {b_ms:.4f} ms "
            f"({100 * b_ms / o_ms:.1f}% / {100 * b_ms / t_ms:.1f}%); this "
            f"vs plain: values on valid rows and in_win equal")
        for name, lib in ablations.items():
            log(f"B3 {label}, {name}: "
                f"{median_ms(gather_launcher(lib, args)):.4f} ms")
    torch.cuda.empty_cache()


def run_path(name: str, other_dir: Path) -> None:
    code = PATH_RUN.replace("rec = {call}",
                            (RESORT if name == "resort" else "")
                            + "rec = " + PATHS[name])
    for label, cwd in (("other", other_dir), ("this", ROOT), ("this", ROOT),
                       ("other", other_dir)):
        out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if "steps/s" in line or "inputs" in line \
                    or line.startswith("kernel record"):
                log(f"{name} path, {label}: {line}")
        if out.returncode:
            raise RuntimeError(f"the {name} path of {cwd} failed:\n"
                               f"{out.stderr}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="a directory holding another commit's "
                         "fusion_sim_torch/ and chip_smoke.py")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to pair, of " + ",".join(KERNELS))
    ap.add_argument("--ablate", action="store_true")
    for name in PATHS:
        ap.add_argument(f"--{name}-path", action="store_true")
    ns = ap.parse_args(argv)
    kernels = [k for k in ns.kernels.split(",") if k]
    if set(kernels) - set(KERNELS):
        ap.error(f"--kernels takes {','.join(KERNELS)}")
    if not torch.cuda.is_available():
        sys.exit("kernel_pair needs a CUDA card")
    other_dir = ns.other.resolve()
    other_csrc = other_dir / "fusion_sim_torch" / "csrc"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_all()
    stems = {"b4": "em2d_substep", "b5": "es3d_substep", "b3": "gather2d",
             "b6": "em3d_substep", "x1": "contraction_depth"}
    sources = {f"other_{k}": other_csrc / f"{stems[k]}.cu" for k in kernels
               if k in stems}
    ablate_dir = _build.BUILD / "ablate"
    for k in ("b4", "b5", "b3", "b6"):
        if ns.ablate and k in kernels:
            sources.update(ablated_sources(
                _build.CSRC / f"{stems[k]}.cu", ablate_dir, "this"))
            if k == "b4":
                sources.update(ablated_sources(
                    _build.CSRC / "em2d_substep.cu", ablate_dir, "this",
                    B4_VARIANTS))
            if k != "b3":
                sources.update(ablated_sources(
                    other_csrc / f"{stems[k]}.cu", ablate_dir, "other"))
    libs = build(sources, other_dir / "fusion_sim_torch" / "build")

    def ablations(stem):
        return {name.split(" ", 1)[1]: lib for name, lib in libs.items()
                if name.startswith(stem + " ")}
    cs = smoke()
    for k in kernels:
        if k == "b4":
            b4_pairs(libs["other_b4"], ablations("em2d_substep"), cs)
        elif k == "b5":
            b5_pairs(libs["other_b5"], ablations("es3d_substep"), cs)
        elif k == "b3":
            b3_pairs(libs["other_b3"], ablations("gather2d"), cs)
        elif k == "b6":
            b6_pairs(libs["other_b6"], ablations("em3d_substep"))
        elif k == "y1":
            y1_pairs(other_dir)
        elif k == "t1":
            t1_pairs(other_dir)
        else:
            x1_pairs(libs["other_x1"])
    for name in PATHS:
        if getattr(ns, f"{name.replace('-', '_')}_path"):
            run_path(name, other_dir)


if __name__ == "__main__":
    main()
