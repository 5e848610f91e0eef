"""Thousands of clock cycles per active lane-step that the megastep spends
in the stage pass of its ADMM iterations (the z-update and the next
sweep's linear terms, which re-read s, lam, lb, ub and q0), from the
kernel's own section counters."""

from benchmark.sections import kcycles


def read(run):
    return kcycles("megastep_kernel", ("stage_pass",))
