"""Thousands of clock cycles per active lane-step that the racestep spends
in its ADMM iterations (backward sweep and forward rollout, stage pass,
termination test and the 128-lane vote with its wait), from the kernel's
own section counters (lane thread 0's clock64, summed per section)."""

from benchmark.sections import ADMM, kcycles


def read(run):
    return kcycles("racestep_kernel", ADMM)
