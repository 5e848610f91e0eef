#!/usr/bin/env python3
"""Readings for the limits of one cell's comparison, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 3 --seconds 2 [--out readings.jsonl]

For every seed it runs the cell as the benchmark does (a short window at
the cell's own sizes and load) and prints the numbers the comparison
computes: the program against the reference (the sound readings). On the
first ``--control-seeds`` seeds it also prints the same numbers with the
reference computed with TF32 products put in the program's place, from the
same carries (the control's readings). Needs the card; the limits in
``workloads/<cell>.json`` are then set between the two (PERF.md)."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from benchmark import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", t_start=t,
                               controls=("tf32",) if i < args.control_seeds else ())
        row = {"cell": args.workload, "seed": seed, "sound": res["_numbers"],
               "control": res["_controls"].get("tf32"), "correct": res["correct"],
               "solves_per_s": res["metrics"].get("solves_per_s", {}).get("value"),
               "wall_s": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
