"""The readings that the limits of ``correct`` are set from: for each
seed, one run of a cell at its own size (a short window) with the numbers
the program gives at its checked steps, and beside them the numbers of
the lower-precision control (the reference computed with every grid,
field and velocity in bfloat16, positions in float32, put in the
program's place).  The benchmark's own runs never run this.

    python3 port_bench/control.py --workload em3d-128cube-30m.thermal-resort \
        --seconds 2 --seeds 11 12 13

One JSON line a seed on standard output (and appended to ``--out``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, report = harness.run(args.workload, seed, args.seconds,
                                     False, "cuda", t0, control=True)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"], "attempted": result["attempted"],
            "program": {k: c["value"] for k, c in result["checks"].items()},
            "control": result["control"],
            "metrics": {k: m["value"] for k, m in result["metrics"].items()},
            "seconds": time.perf_counter() - t0})
        print("\n".join(report), file=sys.stderr)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
