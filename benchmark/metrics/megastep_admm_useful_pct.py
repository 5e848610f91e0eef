"""Share of the ADMM iterations the megastep executed that each lane itself
needed: the lanes' own done-ats over the iterations they ran, from the
kernel's own counters. The rest ran because the lane's 128-lane group had
not all passed the termination test (the early-exit vote)."""

from benchmark.sections import totals


def read(run):
    tot = totals("megastep_kernel")
    if tot is None or not tot["lane_iters"]:
        return None
    return 100.0 * tot["lane_doneat"] / tot["lane_iters"]
