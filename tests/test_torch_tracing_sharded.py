"""The program's own spans and counters (``fusion_sim_torch/utils/
profiling.py``) in the sharded 3D ES shell, on the CPU, in a world of one.

The shell (``ShardedElectrostaticPIC``, pallas path: kernel B5's plain
version) runs the small slab of the configuration ``es3d-slab512-125m``
(16 x 32 x 32 cells, 4 particles a cell, its tiling and cadence) with a
hot plasma, 0.25 cells a step, so that rows leave their windows and cross
both x faces from the first steps.  Two resort windows and one call more
of ``step(1)`` (two calls open with a resort) run under
``torch.profiler`` (CPU activity);
an untraced twin built from the same inputs runs the same calls under
the host clock, and a third copy, resorted by hand before the calls that
resort, pairs each step's rows to count those that crossed a face.

The world is a gloo world of one in a process of its own
(``torch_ranks.run_world``), so that its process group does not outlive
the test; what the tests read is reduced there to plain values.
"""

import copy
import json
import math

import pytest

from port_bench import harness
from torch_ranks import one_torch_thread, run_world  # noqa: F401

CONFIG = json.loads((harness.ROOT / "port_bench/configs/"
                     "es3d-slab512-125m.json").read_text())
SHAPE, PER_CELL = [16, 32, 32], 4
SEED = 2 ** 33 + 41
V_HOT = 0.25 * (2 * math.pi / 128) / 0.05    # 0.25 cells a step
LEAVES = {"fusion_sim." + n for n in ("solve", "halo", "kernel", "patch",
                                      "migrate", "resort")}
# a step's spans: the solve's two (the Poisson solve, the gradient), the
# phi and E halos and the apron fold, the kernel, the patch, migration,
# and the spill count's read
PER_STEP = {"solve": 2, "halo": 3, "kernel": 1, "patch": 1, "migrate": 1,
            "host_read": 1}


def _small():
    config = copy.deepcopy(CONFIG)
    n = math.prod(SHAPE) * PER_CELL
    d = 2 * math.pi / 128
    vol = math.prod(SHAPE) * d ** 3
    config["physics"].update(grid_shape=SHAPE, cell_size=[d] * 3,
                             charge=-vol / n, mass=vol / n)
    config["n_particles"] = n
    config["shell"].update(capacity=n, migration_buffer=1024)
    config["layouts"]["resort"]["shell"]["spill_capacity"] = n
    return config


def _ancestors(event):
    out, e = [], event.cpu_parent
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


def _scalar_reads(fn):
    """Device-to-host scalar reads (``aten::_local_scalar_dense``) while
    ``fn`` runs, seen by a dispatch mode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                Reads.n += 1
            return func(*args, **(kwargs or {}))

    with Reads():
        fn()
    return Reads.n


def tracing_body(rank, inp):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fusion_sim_torch.utils import profiling
    from port_bench import inputs
    from port_bench.kinds import electrostatic3d_sharded as kind

    config = inp["config"]
    layout = config["layouts"]["resort"]
    traffic = {"layout": "resort",
               "populations": [{"share": 1.0, "v_thermal": V_HOT}]}
    x, v = inputs.make(config, traffic, SEED, "cpu")
    sim, twin, pair = (kind.build(config, layout, x.numpy(), v.numpy(),
                                  "cpu") for _ in range(3))
    cadence = sim.config.resort_every
    calls = 2 * cadence + 1
    s0 = sim.state

    # the rows that cross a face, step by step, on the paired copy
    crossed = 0
    for _ in range(calls):
        if pair._since_sort >= cadence:
            pair.state = pair._resort(pair.state)
            pair._since_sort = 0
        x0 = pair.state.position[:, 0].clone()
        pair.step(1)
        dx = (pair.state.position[:, 0] - x0).abs()
        crossed += int((pair.state.alive & (dx > SHAPE[0] / 2)).sum())

    due, reads = 0, 0
    profiling.span("step")      # seen untraced: the recording counts anew
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            due += sim._since_sort >= cadence
            reads += _scalar_reads(lambda: sim.step(1))
    counts = profiling.counters()
    events = list(prof.events())
    profiling._reset_clock()
    twin_reads = sum(_scalar_reads(lambda: twin.step(1))
                     for _ in range(calls))
    with profiling.span("step"):        # closes the last call's record
        pass
    clock = profiling.host_times()

    bad, seen = [], 0
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        up = _ancestors(e)
        if "fusion_sim.step" not in up:
            continue
        seen += 1
        if len([a for a in up if a in LEAVES]) != 1:
            bad.append((e.name, up))
    spans = {}
    for e in events:
        if e.name.startswith("fusion_sim."):
            name = e.name[len("fusion_sim."):]
            spans[name] = spans.get(name, 0) + 1
    s1 = sim.state
    same = {k: bool(torch.equal(a, getattr(twin.state, k)))
            for k, a in s1._asdict().items() if torch.is_tensor(a)}
    return {"calls": calls, "due": due, "seen": seen, "bad": bad[:5],
            "spans": spans, "counts": counts, "crossed": crossed,
            "patched": int((s1.spill - s0.spill).sum()
                           - (s1.spill_dropped - s0.spill_dropped).sum()),
            "dropped": sim.rows_dropped, "same": same, "reads": reads,
            "twin_reads": twin_reads, "clock": clock}


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    return run_world(1, tracing_body, {"config": _small()},
                     tmp_path_factory.mktemp("tracing"))[0]


def test_every_op_in_a_step_has_one_leaf_phase(recording):
    assert recording["seen"] > 0
    assert recording["bad"] == []


def test_span_counts(recording):
    calls, n = recording["calls"], recording["spans"]
    assert n["step"] == calls
    assert n["resort"] == 2 == recording["due"]
    assert {k: n[k] for k in PER_STEP} == {k: c * calls
                                          for k, c in PER_STEP.items()}
    assert set(n) == set(PER_STEP) | {"step", "resort"}


def test_clock_counts_each_span_as_the_profiler(recording):
    """The untraced twin's host clock saw every call and every span; the
    clock keeps the halo and migrate spans under its phase "other"."""
    clock, spans = recording["clock"], dict(recording["spans"])
    assert clock["calls"] == recording["calls"]
    spans["other"] = spans.pop("halo") + spans.pop("migrate")
    assert {k: c for k, c in clock["count"].items() if c} == spans
    assert clock["self_ns"]["other"] > 0


def test_rows_migrated_counts_the_rows_that_crossed(recording):
    assert recording["crossed"] > 0
    assert recording["counts"]["rows_migrated"] == recording["crossed"]


def test_rows_patched_is_the_state_delta(recording):
    assert recording["patched"] > 0 and recording["dropped"] == 0
    assert recording["counts"]["rows_patched"] == recording["patched"]


def test_traced_state_is_bit_identical(recording):
    assert recording["same"] and all(recording["same"].values()), \
        recording["same"]


def test_spans_add_no_host_read(recording):
    """The same scalar reads traced and untraced: the spill count's, one a
    step (and none of the counters, read after the recording)."""
    assert recording["reads"] == recording["twin_reads"] \
        == recording["calls"]
