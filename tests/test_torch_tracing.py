"""The program's own spans and counters (``fusion_sim_torch/utils/
profiling.py``: ``span``, ``count``, ``counters``) in the two PIC shells
that the benchmark runs, on tiny models on the CPU.

Six models: the ES shell on its pallas path under resort and under
repair, the EM shell on its fused 3D path under resort and under repair
and on its fused 2D3V path under resort (rows by cell), and the 3D ES
shell on its pallas path under resort (kernel B5's plain version, rows
by cell), at
``port_bench/tests/tiny.py``'s sizes with a one-cell sort margin and a
hot plasma, so that rows spill from the first steps.  Each is stepped
under ``torch.profiler`` (CPU activity) beside an untraced twin built
from the same inputs, whose calls the host clock behind ``span`` times
(``host_times``)."""

import contextlib
import copy
import json
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fusion_sim_torch.utils import profiling
from port_bench import harness, inputs
from port_bench.tests.tiny import tiny_config
from torch_ranks import one_torch_thread  # noqa: F401

LEAVES = {"fusion_sim." + n for n in ("solve", "fields", "kernel", "patch",
                                      "repair", "finish", "resort",
                                      "drain_check")}
SEED = 2 ** 33 + 11
# model: (the benchmark's configuration, by a cell of it; layout; thermal
# speed; the resort layout's patch capacity, small enough that some rows
# are dropped)
MODELS = {
    "es_resort": ("es2d-512sq-10m.thermal-resort", "resort", 1.0, 512),
    "es_repair": ("es2d-512sq-10m.thermal-resort", "repair", 1.0, None),
    "em_resort": ("em3d-128cube-30m.thermal-resort", "resort", 1.0, 128),
    "em_repair": ("em3d-128cube-30m.thermal-repair", "repair", 1.0, None),
    "em2d_resort": ("em2d3v-512sq-10m.weibel-resort", "resort", 1.0, 128),
    "es3d_resort": ("es3d-128cube-30m.thermal-resort", "resort", 1.0, 128),
}


def _build(name):
    workload, layout, v_th, cap = MODELS[name]
    config = tiny_config(workload)
    config["tiling"]["margin"] = 1
    lay = copy.deepcopy(config["layouts"][layout])
    if cap is not None:
        lay["shell"]["spill_capacity"] = cap
    traffic = {"layout": layout,
               "populations": [{"share": 1.0, "v_thermal": v_th}]}
    x, v = inputs.make(config, traffic, SEED, "cpu")
    return harness.kind(config).build(config, lay, x.numpy(), v.numpy(),
                                      torch.device("cpu"))


def _ancestors(event):
    out, e = [], event.cpu_parent
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


@pytest.fixture(scope="module", params=sorted(MODELS))
def recording(request):
    """A model stepped ``calls`` times by ``step(1)`` under the profiler
    from its build, and its twin stepped untraced."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sim, twin = _build(request.param), _build(request.param)
        repair = sim.repair
        calls = 4 if repair else 2 * sim.resort_every + 1
        s0 = sim.state
        due = []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(calls):
                due.append(sim._since_sort >= sim.resort_every
                           or sim._need_resort)
                sim.step(1)
        counts = profiling.counters()
        profiling._reset_clock()
        seen = []
        for _ in range(calls):
            twin.step(1)
            seen.append(profiling.host_times())
        with profiling.span("step"):    # closes the last call's record
            pass
        seen.append(profiling.host_times())
        yield dict(name=request.param, sim=sim, twin=twin, s0=s0,
                   calls=calls, repair=repair, due=sum(due),
                   events=list(prof.events()), counts=counts,
                   records=[_less(b, a) for a, b in zip(seen, seen[1:])])
    finally:
        torch.set_num_threads(saved)


def _less(a, b):
    """Host times ``a`` less ``b``: the records ``a`` holds beyond ``b``."""
    return {"calls": a["calls"] - b["calls"],
            "wall_ns": a["wall_ns"] - b["wall_ns"],
            **{k: {p: a[k][p] - b[k][p] for p in a[k]}
               for k in ("self_ns", "count")}}


def test_span_off_is_the_shared_noop():
    """With no profiler every name, known or not, gets the one shared host
    clock (nothing is made per call, and timing spans keeps no memory),
    and counts add nothing."""
    sim = _build("es_resort")
    before = profiling.counters()
    a, b = profiling.span("step"), profiling.span("patch")
    assert a is b is profiling._CLOCK
    assert profiling.span("no such phase") is a
    profiling.count("rows_patched", 5)
    sim.step(2)
    assert profiling.counters() == before
    tracemalloc.start()
    try:
        for _ in range(1000):           # lists and ints warm
            with profiling.span("kernel"):
                pass
        held = tracemalloc.get_traced_memory()[0]
        for _ in range(10000):
            with profiling.span("kernel"):
                with profiling.span("host_read"):
                    pass
        assert tracemalloc.get_traced_memory()[0] - held < 1024
    finally:
        tracemalloc.stop()


def test_every_op_in_a_step_has_one_leaf_phase(recording):
    seen = 0
    for e in recording["events"]:
        if not e.name.startswith("aten::"):
            continue
        up = _ancestors(e)
        if "fusion_sim.step" not in up:
            continue
        seen += 1
        leaves = [a for a in up if a in LEAVES]
        assert len(leaves) == 1, (e.name, up)
    assert seen > 0


def test_span_counts(recording):
    n = {}
    for e in recording["events"]:
        if e.name.startswith("fusion_sim."):
            n[e.name] = n.get(e.name, 0) + 1
    calls = recording["calls"]
    assert n["fusion_sim.step"] == calls
    # the spill count a step, and with repair the drain check's read
    assert n["fusion_sim.host_read"] == calls * (2 if recording["repair"]
                                                 else 1)
    if recording["repair"]:
        assert n["fusion_sim.drain_check"] == calls
        assert n.get("fusion_sim.resort", 0) == recording["due"]
    else:
        assert n["fusion_sim.resort"] == 2 == recording["due"]
    assert set(n) <= LEAVES | {"fusion_sim.step", "fusion_sim.host_read"}


def _span_counts_by_call(events):
    """The profiler's ``fusion_sim.*`` spans by the ``step`` span that holds
    their start, in call order: [{phase: count}]."""
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "fusion_sim.step")
    out = [{} for _ in steps]
    for e in events:
        if not e.name.startswith("fusion_sim.") or e.name == "fusion_sim.step":
            continue
        i = next(i for i, (a, b) in enumerate(steps)
                 if a <= e.time_range.start <= b)
        name = e.name[len("fusion_sim."):]
        out[i][name] = out[i].get(name, 0) + 1
    return out


def test_clock_counts_each_span_as_the_profiler(recording):
    """Call by call, the host clock's span counts in the untraced twin
    equal the profiler's spans in the traced model."""
    records = recording["records"]
    assert [r["calls"] for r in records] == [1] * recording["calls"]
    for rec, seen in zip(records, _span_counts_by_call(recording["events"])):
        assert rec["count"]["step"] == 1
        assert {k: n for k, n in rec["count"].items()
                if n and k != "step"} == seen


def test_clock_self_times_lie_within_the_wall(recording):
    for rec in recording["records"]:
        assert all(t >= 0 for t in rec["self_ns"].values()), rec
        assert rec["self_ns"]["step"] > 0
        assert sum(rec["self_ns"].values()) <= rec["wall_ns"], rec


@pytest.fixture
def planted(monkeypatch):
    """A new host clock on a planted time source, ``now[0]`` ns; a new
    clock on the real one afterwards."""
    now = [0]
    monkeypatch.setattr(profiling, "_now", lambda: now[0])
    profiling._reset_clock()
    yield now
    monkeypatch.undo()
    profiling._reset_clock()


def test_host_read_is_not_in_its_parents_self_time(planted):
    """On a planted clock: a host read inside a patch inside a step, and
    the next step's entry."""
    now = planted

    def at(t, ctx, enter):
        now[0] = t
        ctx.__enter__() if enter else ctx.__exit__(None, None, None)

    step = profiling.span("step")
    at(0, step, True)
    patch = profiling.span("patch")
    at(10, patch, True)
    read = profiling.span("host_read")
    at(20, read, True)
    at(50, read, False)
    at(60, patch, False)
    at(70, step, False)
    at(100, profiling.span("step"), True)
    at(100, step, False)
    times = profiling.host_times()
    assert times["calls"] == 1 and times["wall_ns"] == 100
    assert {k: t for k, t in times["self_ns"].items() if t} \
        == {"step": 20, "patch": 20, "host_read": 30}
    assert {k: n for k, n in times["count"].items() if n} \
        == {"step": 1, "patch": 1, "host_read": 1}


def _planted_records(now, n):
    """``n`` step calls on the planted clock, record i: wall i + 7 ns, a
    kernel span of i + 1 ns, step self time 3 ns; the last closed by a
    further, empty step call.  Returns the walls."""
    walls = []
    for i in range(n + 1):
        step = profiling.span("step")
        step.__enter__()
        if i == n:
            step.__exit__(None, None, None)
            break
        now[0] += 1
        kernel = profiling.span("kernel")
        kernel.__enter__()
        now[0] += i + 1
        kernel.__exit__(None, None, None)
        now[0] += 2
        step.__exit__(None, None, None)
        now[0] += 3
        walls.append(i + 7)
    return walls


@pytest.mark.parametrize("n", [100, 600])
def test_ring_keeps_the_last_512_records(planted, n):
    """The ring's sums over the last min(512, n) records equal a plain sum
    of those records, before and after evictions; a recording freezes
    them, and calls after it leave them."""
    walls = _planted_records(planted, n)
    assert profiling.RING == 512
    last = walls[-512:]
    want = {"calls": len(last), "wall_ns": sum(last),
            "self_ns": {**{p: 0 for p in profiling.PHASES},
                        "step": 3 * len(last),
                        "kernel": sum(w - 6 for w in last)},
            "count": {**{p: 0 for p in profiling.PHASES},
                      "step": len(last), "kernel": len(last)}}
    assert profiling.host_times() == want
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.span("step")
    for _ in range(3):
        with profiling.span("step"):
            with profiling.span("kernel"):
                pass
    assert profiling.host_times() == want


def test_host_times_freeze_when_a_recording_starts():
    """A tiny model: the calls before a recording give the ring's records
    (the last call's record is still open, and dropped); the recording's
    calls and those after it leave ``host_times()`` as it was."""
    sim = _build("es_resort")
    profiling._reset_clock()
    assert profiling.host_times()["calls"] == 0
    for _ in range(5):
        sim.step(1)
    live = profiling.host_times()
    assert live["calls"] == 4 and live["count"]["step"] == 4
    with profile(activities=[ProfilerActivity.CPU]):
        sim.step(2)
        assert profiling.host_times() == live
    for _ in range(3):
        sim.step(1)
    assert profiling.host_times() == live


@pytest.mark.parametrize("name", sorted(MODELS) + ["pusher"])
def test_clock_adds_no_host_read(name, monkeypatch):
    """Twins from one build, one timed by the host clock and one with the
    clock replaced by a no-op context: the same scalar reads, the same
    state, and the counters as they were."""
    if name == "pusher":
        timed, plain = _pusher(), _pusher()
        run, state = (lambda sim: _frames(sim, 3)), "_sorted_state"
    else:
        timed, plain = _build(name), _build(name)
        run, state = (lambda sim: sim.step(3)), "state"
    before = profiling.counters()
    profiling._reset_clock()
    a = _scalar_reads(lambda: run(timed))
    with profiling.span("step"):        # closes the last call's record
        pass
    assert profiling.host_times()["count"]["host_read"] > 0
    monkeypatch.setattr(profiling, "_CLOCK", contextlib.nullcontext())
    assert _scalar_reads(lambda: run(plain)) == a > 0
    assert profiling.counters() == before
    for key, x in getattr(timed, state)._asdict().items():
        y = getattr(getattr(plain, state), key)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), key


def test_rows_patched_is_the_state_delta(recording):
    s0, s1 = recording["s0"], recording["sim"].state
    patched = (s1.spill - s0.spill) - (s1.spill_dropped - s0.spill_dropped)
    assert patched > 0
    assert recording["counts"]["rows_patched"] == patched
    if not recording["repair"]:
        assert s1.spill_dropped > s0.spill_dropped   # min(spill, capacity)


def test_layouts_sorted_counts_each_layout(recording):
    """On the CPU every layout takes the stable sort: one count a resort
    of the recording (the build came before it)."""
    assert recording["counts"].get("layouts_sorted", 0) == recording["due"]
    assert "layouts_bucketed" not in recording["counts"]


def test_layouts_sorted_adds_no_host_read():
    """Two twins of the 2D3V shell (rows by cell) from one build, a call
    at a time, the first under a recording: a resort every 2 calls counts
    one layout in each call that opens with it, and both twins read the
    same scalars."""
    traced, plain = _build("em2d_resort"), _build("em2d_resort")
    traced.resort_every = plain.resort_every = 2
    for call in range(1, 6):
        with profile(activities=[ProfilerActivity.CPU]):
            a = _scalar_reads(lambda: traced.step(1))
            counts = profiling.counters()
        assert a == _scalar_reads(lambda: plain.step(1))
        assert counts.get("layouts_sorted", 0) == (call in (3, 5)), call


def test_traced_state_is_bit_identical(recording):
    a, b = recording["sim"].state, recording["twin"].state
    for key, x in a._asdict().items():
        y = getattr(b, key)
        if torch.is_tensor(x):
            assert torch.equal(x, y), key
        else:
            assert x == y, key


def test_a_new_recording_resets_the_counters():
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("rows_patched", 3)
        profiling.count("rows_patched", 4)
    assert profiling.counters() == {"rows_patched": 7}
    profiling.span("step")              # a call that sees no profiler
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("other", 1)
    assert profiling.counters() == {"other": 1}


def test_trace_resets_and_writes_counters(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("before", 1)
    # no call between the two recordings saw the profiler off
    with profiling.trace(str(tmp_path)):
        with profiling.span("step"):
            profiling.count("rows_patched", 2)
    assert json.loads((tmp_path / "counters.json").read_text()) \
        == {"rows_patched": 2}
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert "fusion_sim.step" in names


# -- the pusher shell ----------------------------------------------------------

PUSHER_LEAVES = {"fusion_sim." + n for n in ("kernel", "patch", "respawn",
                                             "finish", "resort", "density")}


def _pusher(seed=7):
    """The app's scenario on 32 x 64 cells with 16^2 fast rows over the
    vessel, on the sorted fused path with a two-cell margin, resorting
    every 3 frames: rows leave their windows and reach the walls each
    frame."""
    import numpy as np

    from fusion_sim_torch.models.pusher import CylindricalParticlePusher
    from fusion_sim_torch.ops.fused_pusher import stream_tiling_for
    from fusion_sim_torch.scenarios import apply_default_scenario

    spec = {"radius": 1.0, "height": 2.0, "nr": 32, "nz": 64, "dt": 2e-9,
            "nparticles": 16, "particle_mass": 1.67e-27,
            "particle_charge": 1.602e-19}
    sim = CylindricalParticlePusher(spec, seed=seed, device="cpu")
    apply_default_scenario(sim, seed=seed)
    rng = np.random.default_rng(seed)
    r, th = np.sqrt(rng.random(256)), 2 * np.pi * rng.random(256)
    sim.set({"position": np.stack([r * np.cos(th), r * np.sin(th),
                                   2 * rng.random(256)], -1),
             "velocity": 0.02 * rng.standard_normal((256, 3))})
    sim.enable_sorted_path(tiling=stream_tiling_for(32, 64, margin=2),
                           resort_every=3, backend="fused",
                           spill_capacity=4096, respawn_capacity=2048)
    return sim


def _frames(sim, n):
    for _ in range(n):
        sim.step(1)
        sim.density()


@pytest.fixture(scope="module")
def pusher_recording():
    """Seven app frames of the sorted fused pusher under the profiler (two
    open with a resort), and the respawns of each half-step, counted
    from the rows that each sink/respawn pass absorbs."""
    from fusion_sim_torch.models import pusher_sorted

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    orig = pusher_sorted.sink_respawn
    absorbed = []

    def sink_respawn(next_pos, sink, *args, **kw):
        absorbed.append(int((sink <= 0.5).sum()))
        return orig(next_pos, sink, *args, **kw)

    try:
        sim = _pusher()
        pusher_sorted.sink_respawn = sink_respawn
        profiling.span("step")      # seen untraced: the recording counts anew
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _frames(sim, 7)
        counts = profiling.counters()
    finally:
        pusher_sorted.sink_respawn = orig
        torch.set_num_threads(saved)
    return dict(sim=sim, events=list(prof.events()), counts=counts,
                absorbed=absorbed)


def test_pusher_ops_have_one_leaf_phase(pusher_recording):
    """Every operation of a frame, inside ``step`` or ``density``, lies in
    exactly one leaf phase."""
    seen = 0
    for e in pusher_recording["events"]:
        if not e.name.startswith("aten::"):
            continue
        up = _ancestors(e)
        if not {"fusion_sim.step", "fusion_sim.density"} & set(up):
            continue
        seen += 1
        leaves = [a for a in up if a in PUSHER_LEAVES]
        assert len(leaves) == 1, (e.name, up)
    assert seen > 0


def test_pusher_span_counts(pusher_recording):
    n = {}
    for e in pusher_recording["events"]:
        if e.name.startswith("fusion_sim."):
            n[e.name] = n.get(e.name, 0) + 1
    assert n["fusion_sim.step"] == n["fusion_sim.density"] == 7
    assert n["fusion_sim.resort"] == 2              # frames 4 and 7
    # the spill count and the respawn count of each half-step
    assert n["fusion_sim.host_read"] == 7 * 2 * 2
    assert set(n) <= PUSHER_LEAVES | {"fusion_sim.step",
                                      "fusion_sim.host_read"}


def test_rows_respawned_counts_the_respawns(pusher_recording):
    absorbed = pusher_recording["absorbed"]
    assert len(absorbed) == 14 and sum(absorbed) > 0
    assert pusher_recording["counts"]["rows_respawned"] == sum(absorbed)
    assert pusher_recording["counts"]["rows_patched"] \
        == pusher_recording["sim"]._sorted_state.spill > 0
    assert pusher_recording["sim"]._sorted_state.dropped == 0


def _scalar_reads(fn):
    """Device-to-host scalar reads (``aten::_local_scalar_dense``) while
    ``fn`` runs, seen by a dispatch mode (which needs no profiler)."""
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


def test_pusher_spans_add_no_host_read():
    """Two twins from one build, one frame each at a time, the first
    under a recording: both read the same scalars, two a half-step (the
    spill count and the respawn count) on frames without a resort, and
    end in the same state."""
    traced, plain = _pusher(), _pusher()
    for frame in range(5):
        with profile(activities=[ProfilerActivity.CPU]):
            a = _scalar_reads(lambda: _frames(traced, 1))
        b = _scalar_reads(lambda: _frames(plain, 1))
        assert a == b
        if frame != 3:                      # frame 4 opens with a resort
            assert a == 4, frame
    for key, x in traced._sorted_state._asdict().items():
        y = getattr(plain._sorted_state, key)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), key
