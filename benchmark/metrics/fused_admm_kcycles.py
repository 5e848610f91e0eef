"""Thousands of clock cycles per active lane-step that the fused kernel
spends in its ADMM iterations (backward sweep and forward rollout, stage
pass, termination test and vote), from the kernel's own section
counters."""

from benchmark.sections import ADMM, kcycles


def read(run):
    return kcycles("fused_kernel", ADMM)
