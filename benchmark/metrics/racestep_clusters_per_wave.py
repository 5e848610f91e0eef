"""Clusters of 128 lanes that the card holds at once on the racestep's
launches: how many lanes run together, which the kernel's shared memory
per block (its ADMM operand slices) and registers set."""

from benchmark.waves import clusters_per_wave


def read(run):
    return clusters_per_wave("racestep_kernel")
