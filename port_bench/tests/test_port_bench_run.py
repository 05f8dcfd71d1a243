"""A run's shape: the result line's keys, the numbers beside their
limits, the cadence of the checked steps, the refusal without a card,
and no JAX anywhere in the harness."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench import harness
from port_bench.tests.tiny import run_tiny

CELL = "es2d-512sq-10m.thermal-resort"


def test_result_line_keys_untraced():
    result, report = run_tiny(CELL)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"particle_updates_per_s",
                                      "step_ms_p95.host_bound",
                                      "peak_mem_gib", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    limits = harness.load_cell(CELL).config["limits"]
    assert set(result["checks"]) == set(limits)
    assert report[-len(limits):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}"
        for k, c in result["checks"].items()]


def test_result_line_keys_traced():
    result, _ = run_tiny("em3d-128cube-30m.thermal-repair", traced=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU trace holds no device operation: every reader stays silent
    assert result["metrics"] == {}
    json.dumps(result)


@pytest.mark.parametrize("done,cadence,repair,expect", [
    (23, 12, False, (24, 25)),      # call 25 opens with a resort
    (24, 12, False, (25, 26)),      # the next call itself resorts
    (25, 12, False, (26, 37)),
    (7, 6, False, (8, 13)),
    (100, 10 ** 9, True, (101, 102)),
])
def test_checked_calls(done, cadence, repair, expect):
    assert harness.checked_calls(done, cadence, repair) == expect


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", CELL,
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_jax_after_a_run():
    code = ("from port_bench import harness\n"
            "from port_bench.tests.tiny import run_tiny\n"
            "run_tiny('em3d-128cube-30m.thermal-resort', traced=True)\n"
            "print(harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=harness.ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_jax():
    banned = {"jax", "jaxlib", "flax", "fusion_sim_tpu", "bench",
              "chip_smoke"}
    for path in harness.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "fusion_sim_tpu.ops", sys)
    assert "fusion_sim_tpu" in harness.forbidden_modules()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the measurement path has no CPU "
                    "mode")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", cell,
         "--seed", str(2 ** 33 + 1), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
