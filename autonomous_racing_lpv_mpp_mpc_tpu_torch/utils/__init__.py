"""Lap statistics, log records and sweep checkpoints, profiling and
numerical-safety tools, and plots (the JAX package's ``utils``)."""

from .debug import checked_closed_loop, enable_nan_debugging
from .metrics import LapStats, lap_stats
from .plotting import animate_run, plot_predictions, plot_run, plot_track
from .profiling import cost_analysis, timed, trace_to
from .record import SweepCheckpoint, load_log, save_log

__all__ = [
    "SweepCheckpoint",
    "plot_track",
    "plot_run",
    "plot_predictions",
    "animate_run",
    "LapStats",
    "lap_stats",
    "save_log",
    "load_log",
    "timed",
    "trace_to",
    "cost_analysis",
    "enable_nan_debugging",
    "checked_closed_loop",
]
