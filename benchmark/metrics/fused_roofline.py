"""The fused kernel's share of its roofline on the card (see
megastep_roofline), at the configuration's fixed iteration count."""

from benchmark.roofline import kernel_share


def read(run):
    return kernel_share(run, "fused_kernel")
