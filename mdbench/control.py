"""The readings that the limits of a cell's checks are set from:

    python3 -m mdbench.control --workload <cell> --seeds S1 S2 ... \\
        [--calls 2]

For each seed, in one process, one run of the cell as run.py makes it,
with a window of `--calls` run() calls: the program's numbers (the lower
readings) and the control's on the same state (the upper readings: the
reference computed in bfloat16 in the program's place). One JSON line a
seed, then the widest program reading and the narrowest control reading
of each number. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mdbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from . import spec
    from .run import run_cell

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    lower, upper = {}, {}
    for seed in args.seeds:
        res = run_cell(cell, seed, 0.0, False, devices, time.perf_counter(),
                       calls=args.calls, control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": res["numbers"],
                          "control": res["control"]}), flush=True)
        for k, v in res["numbers"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in res["control"].items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
