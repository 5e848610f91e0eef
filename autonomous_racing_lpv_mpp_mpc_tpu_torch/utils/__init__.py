"""Lap statistics and plots (the JAX package's ``utils``; the rest of it,
records, profiling and debugging, comes later)."""

from .metrics import LapStats, lap_stats
from .plotting import animate_run, plot_predictions, plot_run, plot_track

__all__ = [
    "LapStats",
    "animate_run",
    "lap_stats",
    "plot_predictions",
    "plot_run",
    "plot_track",
]
