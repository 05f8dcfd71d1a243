"""Small copies of the benchmark's configurations for the CPU tests: the
same physics, tiling and layouts on a few tiles (each kind's ``tiny`` in
``port_bench/tests/kinds/<model>.py``), with the repair buffers and
warm-up cut to fit."""

import copy

from port_bench import harness
from port_bench.tests import kinds


def kind_tests(model: str):
    """The test module of the kind ``model``; raises where there is none."""
    mod = kinds.of(model)
    if mod is None:
        raise LookupError(f"model {model!r} has no test module "
                          f"port_bench/tests/kinds/{model}.py")
    return mod


def tiny_config(workload: str, config: dict | None = None) -> dict:
    """``config`` (default: the cell's own) cut to its kind's small size."""
    c = copy.deepcopy(config or harness.load_cell(workload).config)
    c = kind_tests(c["model"]).tiny(c)
    rep = c["layouts"].get("repair")
    if rep:
        rep["shell"].update(spill_capacity=4096, repair_free_slots=256)
        rep["warmup_steps"] = 20
    return c


def run_tiny(workload: str, seed: int = 2 ** 33 + 5, seconds: float = 0.3,
             traced: bool = False, control: bool = False,
             config: dict | None = None):
    """One run of ``workload``'s traffic on the CPU at the small size of
    ``config`` (default: the cell's configuration)."""
    return harness.run(workload, seed, seconds, traced, "cpu",
                       config=tiny_config(workload, config),
                       control=control)
