"""Lap statistics of a closed-loop log (the JAX package's
``utils/metrics.py``): lateral error RMS and maximum, mean speed and its
error against a constant reference, solver convergence and iterations, lap
times. Host-side numpy over the log's arrays, which may be tensors on any
device or numpy arrays."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.config import MPCConfig


def as_numpy(a) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a numpy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


@dataclasses.dataclass
class LapStats:
    n_laps: int
    lap_times: List[float]          # [s] per completed lap
    ey_rms: float                   # lateral error RMS over the run [m]
    ey_max: float
    vx_mean: float
    vx_err_rms: Optional[float]     # vs a constant reference if given
    converged_frac: float
    mean_iters: float
    steps: int


def lap_stats(cfg: MPCConfig, log, track_length: float, vx_ref: Optional[float] = None,
              dt: Optional[float] = None) -> LapStats:
    """Statistics of one car's log: ``log.X`` (T, nx), ``log.converged``
    and ``log.iters`` (T,). A lap completes when s crosses a multiple of
    ``track_length``; the first lap counts from step 0."""
    X = as_numpy(log.X)
    dt = dt or cfg.dt
    s_i = 4 if cfg.model == "dynamic" else 2
    ey_i = 5 if cfg.model == "dynamic" else 3
    s, ey, vx = X[:, s_i], X[:, ey_i], X[:, 0]

    crossings = np.floor(s / track_length).astype(int)
    lap_times = []
    for lap in range(1, crossings.max() + 1):
        idx = np.argmax(crossings >= lap)
        prev = np.argmax(crossings >= lap - 1) if lap > 1 else 0
        if idx > prev:
            lap_times.append((idx - prev) * dt)

    return LapStats(
        n_laps=int(crossings.max()),
        lap_times=[round(t, 3) for t in lap_times],
        ey_rms=float(np.sqrt((ey ** 2).mean())),
        ey_max=float(np.abs(ey).max()),
        vx_mean=float(vx.mean()),
        vx_err_rms=float(np.sqrt(((vx - vx_ref) ** 2).mean())) if vx_ref is not None else None,
        converged_frac=float(as_numpy(log.converged).astype(np.float64).mean()),
        mean_iters=float(as_numpy(log.iters).astype(np.float64).mean()),
        steps=int(X.shape[0]),
    )
