"""Small copies of the benchmark's configurations for the CPU tests: the
same physics, tiling and layouts on a few tiles, with the repair buffers
and warm-up cut to fit."""

import copy
import math

from port_bench import harness


def tiny_config(workload: str) -> dict:
    c = copy.deepcopy(harness.load_cell(workload).config)
    if c["model"] == "electrostatic":
        cells, length = 64, 2 * math.pi
        n = cells * cells * 8
        d = length / cells
        c["physics"].update(grid_shape=[cells, cells], cell_size=[d, d],
                            charge=-length ** 2 / n, mass=length ** 2 / n)
    else:
        cells = 16
        n = cells ** 3 * 4
        c["physics"]["grid_shape"] = [cells] * 3
    c["n_particles"] = n
    rep = c["layouts"].get("repair")
    if rep:
        rep["shell"].update(spill_capacity=4096, repair_free_slots=256)
        rep["warmup_steps"] = 20
    return c


def run_tiny(workload: str, seed: int = 2 ** 33 + 5, seconds: float = 0.3,
             traced: bool = False, control: bool = False):
    return harness.run(workload, seed, seconds, traced, "cpu",
                       config=tiny_config(workload), control=control)
