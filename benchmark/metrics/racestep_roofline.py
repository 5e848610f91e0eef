"""The racestep kernel's share of its roofline on the card: the composed
step's operations at each lane's own done-at (measurement, EKF, RLS,
reference rows, the tracker's solve, the world-frame plant;
counts/racestep_kernel.py) and bytes (inputs read once, outputs written
once), against its device time per launch."""

from benchmark.roofline import kernel_share


def read(run):
    return kernel_share(run, "racestep_kernel")
