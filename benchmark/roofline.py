"""A kernel's share of its roofline, as the roofline metrics read it: the
bound of one launch from the benchmark's counts (counts/<kernel>.py) over
the kernel's mean device time per launch in the traced window."""

from benchmark import harness, peaks


def kernel_share(run, kernel: str):
    if run.trace is None:
        return None
    d = run.trace.durations(kernel)
    pk = peaks.for_device(run.device_kind)
    if not d or pk is None:
        return None
    sv = run.config["solver"]
    iters = run.iters_sum / (run.steps * run.lanes) if sv["early_exit"] else float(sv["max_iter"])
    ops, nbytes = harness.plugin("counts", kernel).per_launch(run.setup, run.lanes, iters, run.n_cells)
    return 100.0 * peaks.bound_s(ops, nbytes, pk) / (sum(d) / len(d))
