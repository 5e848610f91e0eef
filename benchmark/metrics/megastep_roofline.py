"""The megastep kernel's share of its roofline on the card: operations at
each lane's own done-at (max_iter without early exit) and bytes (inputs
read once, outputs written once), against its device time per launch."""

from benchmark.roofline import kernel_share


def read(run):
    return kernel_share(run, "megastep_kernel")
