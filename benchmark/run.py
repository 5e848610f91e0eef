#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It builds the port's kernels into the port's own cache in the checkout
(the first run of a checkout compiles), draws the cell's scenarios from the
seed on the card, warms the cell's shapes, measures for ``--seconds``, and
compares a sample of what the measured steps produced with the plain
reference. Standard output's last line is the result (JSON); the numbers
compared, each beside its limit, are standard error's last lines. With
``--trace 1`` the window's first half runs untraced (the whole step's rate)
and its second half under torch.profiler, and the result holds the
per-layer metrics; with ``--trace 0`` the end-to-end ones. No card, or fewer
than the cell asks for: exit 2 with no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run at a fixed path inside the checkout
CACHE = REPO / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(REPO))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "?"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    work_file = REPO / "benchmark" / "workloads" / f"{args.workload}.json"
    if not work_file.is_file():
        log(f"run: no cell named {args.workload!r}")
        return 2
    chips = int(json.loads(work_file.read_text())["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"run: the cell needs {chips} CUDA card(s); this machine has {n}")
        return 2
    from benchmark import harness

    log(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                           t_start=T_START)
    res.pop("_numbers", None)
    res.pop("_controls", None)
    bad = harness.forbidden_modules()
    if bad:
        log(f"run: the process loaded {', '.join(bad)}; the benchmark measures the port alone")
        return 3
    log(f"correct = {res['correct']}")
    for name, c in res["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
