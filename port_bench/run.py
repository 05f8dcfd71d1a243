"""Run one cell of the port's benchmark once on the CUDA card.

    python3 port_bench/run.py --workload es2d-512sq-10m.thermal-resort \
        --seed 12345 --seconds 10 --trace 0

Prints the result as one JSON line, last on standard output, and the
numbers that decided ``correct`` beside their limits as the last lines of
standard error.  ``--trace 1`` reports the cell's per-layer metrics from a
profiled segment instead of its end-to-end metrics.  Exits non-zero and
prints no result without a CUDA card (or with fewer than the cell asks
for), and when JAX or the JAX package is loaded once the window has
closed.  Kernel and compiler caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    cell = next((w for w in harness.load_json(ROOT / "BENCHMARK.json")
                 ["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, report = harness.run(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T0)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"loaded after the window: {', '.join(leaked)}", file=sys.stderr)
        return 4
    for line in report:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
