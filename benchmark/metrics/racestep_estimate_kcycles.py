"""Thousands of clock cycles per active lane-step that the racestep spends
before its tracker: the measurement with its noise, the EKF, the friction
RLS and the reference rows (with their stores), from the kernel's own
section counters: the composed step's own work."""

from benchmark.sections import kcycles

ESTIMATE = ("measure", "ekf", "rls", "refs")


def read(run):
    return kcycles("racestep_kernel", ESTIMATE)
