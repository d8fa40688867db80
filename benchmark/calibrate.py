"""Readings for the limits of the comparison: one cell run on many seeds in
one process, the program as the configuration states it and the control
(the program with the configuration's ``control`` settings, one step below
what it states), each with a short window at the cell's load.

    python3 benchmark/calibrate.py --workload <cell> --seconds 2 \\
        --seeds 1 2 3 ... --control-seeds 101 102 103 [--out calib.jsonl]

Prints one JSON line a run: the seed, whether it was the control, each
number compared and ``correct``.  The benchmark's own runs never run the
control.  ``--control-seeds`` is refused, before any run, for a
configuration whose ``control`` is null.
"""

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    if args.control_seeds:
        try:
            harness.control_config(cell.config)
        except ValueError as e:
            print(f"--control-seeds refused: {e}", file=sys.stderr)
            return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    runs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        t0 = time.perf_counter()
        r = harness.execute(cell, seed, args.seconds, False, control=control)
        line = {"workload": cell.name, "seed": seed, "control": control,
                "correct": r["correct"], "check": r["check"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "attempted": r["attempted"], "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
