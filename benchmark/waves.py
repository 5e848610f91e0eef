"""The clusters of a group kernel that the card holds at once, as the
program kept them at its launches (``utils.profiling.clusters_per_wave`` of
the port): the launch's shape (dynamic shared memory per block, registers)
set against the card's (``cudaOccupancyMaxActiveClusters``). A launch of B
lanes in 128-lane clusters runs in ceil(B / 128 / clusters) waves."""

from __future__ import annotations

import importlib

from benchmark import program


def clusters_per_wave(kernel: str) -> float | None:
    """The fewest clusters per wave of ``kernel``'s launches in this run
    ("megastep_kernel", "fused_kernel"), or None where the port keeps no
    such number or the kernel did not run on a card."""
    try:
        prof = importlib.import_module(f"{program.PACKAGE}.utils.profiling")
    except ImportError:
        return None
    read = getattr(prof, "clusters_per_wave", None)
    fits = read(kernel) if read is not None else None
    return float(min(fits.values())) if fits else None
