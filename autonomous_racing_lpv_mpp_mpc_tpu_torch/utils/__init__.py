"""Lap statistics, plots, log records and sweep checkpoints (the JAX
package's ``utils``; profiling and debugging come later)."""

from .metrics import LapStats, lap_stats
from .plotting import animate_run, plot_predictions, plot_run, plot_track
from .record import SweepCheckpoint, load_log, save_log

__all__ = [
    "LapStats",
    "SweepCheckpoint",
    "animate_run",
    "lap_stats",
    "load_log",
    "plot_predictions",
    "plot_run",
    "plot_track",
    "save_log",
]
