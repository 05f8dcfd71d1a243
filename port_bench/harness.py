"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), the check, and the result line.

Set-up builds the model through the port's public constructor from the
load drawn from the seed (the kind's own ``inputs`` where it defines
one, else ``inputs.make``: ``particle_load``), takes the reference's
moments of the layout it built (timed apart and left out of ``setup_s``)
and runs the configuration's warm-up steps, which reach every shape the
window uses (a resort in resort cells, spill equilibrium in repair
cells).  The window calls ``step(1)`` until ``--seconds`` have passed and
records a CUDA event after each call.  Afterwards the same model runs on
through ``step(1)``, and two of those steps are checked against the
reference (``check.py``): the first after the window and, in resort cells,
the next that resorts (in repair cells, the one after it).  A layout with
``"checked_steps": 1`` checks only the second.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import check, inputs, trace

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fusion_sim_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic and the
    metrics it reports."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(ROOT / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]

    return Cell(workload, config, traffic, mine(bench["end_to_end"]),
                mine(bench["per_layer"]))


def kind(config: dict):
    return importlib.import_module(f"{__package__}.kinds.{config['model']}")


def particle_load(K, config: dict, traffic: dict, seed: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The particle load of a run: ``K.inputs`` where the kind defines
    one, else the common generator ``inputs.make`` (same signature and
    contract, ``inputs.py``)."""
    return getattr(K, "inputs", inputs.make)(config, traffic, seed, device)


def load_file(folder: str, name: str):
    """``port_bench/<folder>/<name>.py`` as a module (names may hold dots)."""
    mod_name = f"{__package__}.{folder}.{name.replace('.', '__')}"
    if mod_name not in sys.modules:
        importlib.import_module(f"{__package__}.{folder}")
        spec = importlib.util.spec_from_file_location(
            mod_name, HERE / folder / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def forbidden_modules() -> list[str]:
    """JAX, its libraries or the JAX package among the loaded modules,
    compared by whole top-level names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def checked_calls(calls_done: int, resort_every: int, repair: bool
                  ) -> tuple[int, int]:
    """The two ``step(1)`` calls to check after ``calls_done``: the next
    one and, without repair, the next that opens with a resort (a call c
    resorts when c > 1 and (c - 1) is a multiple of the cadence); with
    repair, or where the next call itself resorts, the one after it."""
    a = calls_done + 1
    if repair or (a > 1 and (a - 1) % resort_every == 0):
        return a, a + 1
    return a, ((a - 1) // resort_every + 1) * resort_every + 1


@dataclass
class Context:
    """What a per-layer metric reader gets."""

    trace: trace.Summary
    config: dict
    n_particles: int
    grid_shape: tuple
    window_steps: int       # of the untraced window, which precedes the
    window_wall_s: float    # traced segment in every run

    @staticmethod
    def roofline(name: str):
        return load_file("rooflines", name)


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def _to(snap: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in snap.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t0: float | None = None,
        config: dict | None = None, control: bool = False
        ) -> tuple[dict, list[str]]:
    """``(result line, report lines)`` of one run.  ``config`` replaces the
    cell's configuration (the tests' small sizes); ``control`` adds the
    readings of the lower-precision control at the checked steps."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(workload)
    config = config or cell.config
    dev = torch.device(device)
    K = kind(config)
    n = int(config["n_particles"])
    shape = tuple(config["physics"]["grid_shape"])
    layout = config["layouts"][cell.traffic["layout"]]
    repair = bool(layout["shell"].get("repair"))
    cadence = int(layout["shell"].get("resort_every", 1))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- set-up --------------------------------------------------------------
    phases = {"start": time.perf_counter() - t0}
    x_in, v_in = particle_load(K, config, cell.traffic, seed, dev)
    pos, vel = x_in.cpu().numpy(), v_in.cpu().numpy()
    del x_in, v_in
    phases["inputs"] = time.perf_counter() - t0
    sim = K.build(config, layout, pos, vel, dev)
    del pos, vel
    _sync(dev)
    phases["build"] = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated(dev) if cuda else 0
    t_ref = time.perf_counter()
    snap = K.snapshot(sim)
    start_moments = check.moments(snap["x"], snap["v"], shape)
    del snap
    _sync(dev)
    t_ref = time.perf_counter() - t_ref
    peak_start = torch.cuda.max_memory_allocated(dev) if cuda else 0
    calls = 0

    def step():
        nonlocal calls
        sim.step(1)
        calls += 1

    for _ in range(int(layout["warmup_steps"])):
        step()
    gc.collect()
    _sync(dev)
    phases["warm-up"] = time.perf_counter() - t0
    setup_s = phases["warm-up"] - t_ref

    # -- the window ----------------------------------------------------------
    counter = importlib.import_module(config["kernel_counter"])
    launches0, calls0 = counter.LAUNCHES, calls
    dropped = K.dropped(sim)
    failed = 0
    marks = [torch.cuda.Event(enable_timing=True) if cuda
             else time.perf_counter()]
    if cuda:
        marks[0].record()
    t_w = time.perf_counter()
    while time.perf_counter() - t_w < seconds:
        step()
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        now = K.dropped(sim)
        failed += now > dropped
        dropped = now
    _sync(dev)
    wall = time.perf_counter() - t_w
    steps = calls - calls0
    step_ms = [a.elapsed_time(b) if cuda else 1e3 * (b - a)
               for a, b in zip(marks, marks[1:])]

    summary = None
    if traced:
        summary = trace.run_traced(step, int(layout["trace_steps"]), dev,
                                   cell.name)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # -- the steps checked ---------------------------------------------------
    a, b = checked_calls(calls, cadence, repair)
    checked = (a, b)[2 - int(layout.get("checked_steps", 2)):]
    snaps = {}
    while calls < b:
        c = calls + 1
        # the snapshots wait on the host, so that the program's own steps
        # keep the device's memory they had in the window
        before = _to(K.snapshot(sim), "cpu") if c in checked else None
        step()
        if before is not None:
            snaps[c] = (before, _to(K.snapshot(sim), "cpu"))
    launches = (counter.LAUNCHES - launches0) / max(calls - calls0, 1)
    dropped = K.dropped(sim)
    del sim
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------
    t_check = time.perf_counter()
    x_in, v_in = particle_load(K, config, cell.traffic, seed, dev)
    snaps = {c: (_to(bef, dev), _to(aft, dev))
             for c, (bef, aft) in snaps.items()}
    end = snaps[checked[0]][0]
    bad = check.nonfinite(end)
    if bad:
        failed = steps
    in_moments = check.moments(x_in, v_in, shape)
    numbers = {"count": 0.0, "dropped": float(dropped),
               "nonfinite": float(bad + sum(check.nonfinite(s[1])
                                            for s in snaps.values())),
               "start": check.gap(start_moments, in_moments)}
    ctl = {}
    if control:
        ctl["start"] = check.gap(check.moments(
            x_in, v_in.to(torch.bfloat16).float(), shape), in_moments)

    def worst(into, new):
        for k, v in new.items():
            into[k] = max(into.get(k, 0.0), v)

    worst(numbers, K.end_numbers(config, end, x_in, v_in))
    for before, after in snaps.values():
        ref = K.reference_after(config, before)
        worst(numbers, K.step_numbers(config, after, ref, before))
        worst(numbers, K.end_numbers(config, after, x_in, v_in))
        if control:
            low = K.reference_after(config, before, torch.bfloat16)
            worst(ctl, K.step_numbers(config, low, ref, before))
            worst(ctl, K.end_numbers(config, low, x_in, v_in))
            del low
        del ref
    _sync(dev)
    t_check = time.perf_counter() - t_check
    limits = config["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    # -- the result ----------------------------------------------------------
    if traced:
        ctx = Context(summary, config, n, shape, steps, wall)
        metrics = {}
        for m in cell.per_layer:
            value = load_file("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"particle_updates_per_s": n * steps / wall,
                  "step_ms_p95": p95(step_ms),
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        # a name's suffix (".device_bound") scopes a quantity to some cells
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": devinfo}
    if summary is not None:
        devinfo["busy_s"] = summary.busy_s
        devinfo["window_s"] = summary.window_s
        result["breakdown"] = trace.breakdown(summary)
    if control:
        result["control"] = ctl
    result["checks"] = checks
    report = [f"{workload} seed {seed}: {steps} steps in {wall:.6f} s, "
              f"set-up {setup_s:.6f} s, reference moments at set-up "
              f"{t_ref:.6f} s, kernel launches a step {launches:.6f}, "
              f"checked calls {', '.join(map(str, checked))}, "
              f"reference {t_check:.6f} s",
              "set-up phases (s from process start): " + ", ".join(
                  f"{k} {v:.6f}" for k, v in phases.items()),
              f"device peak bytes: after the build {peak_build}, after the "
              f"reference's moments at set-up {peak_start}, run {peak}"]
    report += [f"check {k}: {c['value']!r} limit {c['limit']!r}"
               for k, c in checks.items()]
    return result, report
