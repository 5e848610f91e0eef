"""The kernels' section counters, as the program records them while a
profiler records (``utils.profiling.sections`` of the port): each active
lane's cycles per kernel section and its counts, summed over the traced
launches of the run (the profiler's warm-up session and the traced
window). The per-layer metrics read ratios over the kernel's own
``lane_steps`` or ``lane_iters``, which that scope does not bias."""

from __future__ import annotations

import importlib

from benchmark import program

# the ADMM iterations' sections: backward sweep and forward rollout, the
# stage pass, the termination test with the 128-lane vote
ADMM = ("sweep", "stage_pass", "vote")


def totals(kernel: str) -> dict | None:
    """{counter: total} of ``kernel`` ("megastep_kernel", "fused_kernel"),
    or None where the port keeps no section counters or counted no lane."""
    try:
        prof = importlib.import_module(f"{program.PACKAGE}.utils.profiling")
    except ImportError:
        return None
    read = getattr(prof, "sections", None)
    tot = read(kernel) if read is not None else None
    return tot if tot and tot.get("lane_steps") else None


def kcycles(kernel: str, names) -> float | None:
    """Thousands of cycles per active lane-step in the sections ``names``."""
    tot = totals(kernel)
    return None if tot is None else sum(tot[n] for n in names) / tot["lane_steps"] / 1000.0
