"""Track and run plots (the JAX package's ``utils/plotting.py``): the track
map with its edges and the driven line, state and input traces, predicted
against closed-loop traces, and a car-on-track animation. Every function
returns the figure (``animate_run`` the path) and can save to a path.

matplotlib is imported inside each function, with the headless Agg
backend; where it is not installed, the functions raise ``ImportError``
and nothing else of the package needs it. Logs may hold tensors on any
device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import MPCConfig
from ..track.track import Track, frenet_to_global
from .metrics import as_numpy as _np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _to_global(track: Track, s, e_y):
    """World (X, Y, psi) of Frenet points, as numpy arrays."""
    dev = track.kappa.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    X, Y, psi = frenet_to_global(track, t(s), t(e_y), torch.zeros_like(t(s)))
    return _np(X), _np(Y), _np(psi)


def _track_outline(track: Track, n: int = 600):
    s = np.linspace(0.0, float(track.length) * 0.9999, n)
    half = float(track.width) / 2
    cx, cy, _ = _to_global(track, s, np.zeros_like(s))
    lx, ly, _ = _to_global(track, s, np.full_like(s, half))
    rx, ry, _ = _to_global(track, s, np.full_like(s, -half))
    return cx, cy, lx, ly, rx, ry


def plot_track(track: Track, ax=None):
    """Centerline and edges of the track on ``ax`` (a new figure's if None)."""
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 6))
    cx, cy, lx, ly, rx, ry = _track_outline(track)
    ax.plot(cx, cy, "--", lw=0.7, color="0.6", label="centerline")
    ax.plot(lx, ly, "-", lw=1.2, color="0.2")
    ax.plot(rx, ry, "-", lw=1.2, color="0.2")
    ax.set_aspect("equal")
    return ax


def plot_run(cfg: MPCConfig, track: Track, log, path: Optional[str] = None):
    """Track map with the driven line colored by speed, plus trace panels;
    ``log`` one car's (X (T, nx), U (T, 2), converged (T,))."""
    plt = _pyplot()
    X, U = _np(log.X), _np(log.U)
    s_i = 4 if cfg.model == "dynamic" else 2
    ey_i = 5 if cfg.model == "dynamic" else 3
    gx, gy, _ = _to_global(track, X[:, s_i], X[:, ey_i])

    fig = plt.figure(figsize=(13, 8))
    ax0 = fig.add_subplot(2, 2, (1, 3))
    plot_track(track, ax0)
    sc = ax0.scatter(gx, gy, c=X[:, 0], s=3, cmap="viridis")
    fig.colorbar(sc, ax=ax0, label="vx [m/s]")
    ax0.set_title("driven line")

    t = np.arange(X.shape[0]) * cfg.dt
    ax1 = fig.add_subplot(2, 2, 2)
    ax1.plot(t, X[:, 0], label="vx")
    ax1.plot(t, X[:, ey_i], label="e_y")
    ax1.legend()
    ax1.grid(alpha=0.3)
    ax1.set_xlabel("t [s]")

    ax2 = fig.add_subplot(2, 2, 4)
    ax2.plot(t, U[:, 0], label="delta")
    ax2.plot(t, U[:, 1], label="a")
    ax2.step(t, _np(log.converged).astype(np.float32), lw=0.5, alpha=0.5, label="converged")
    ax2.legend()
    ax2.grid(alpha=0.3)
    ax2.set_xlabel("t [s]")

    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig


def plot_predictions(cfg: MPCConfig, track: Track, log, steps=None, path: Optional[str] = None):
    """The N-step predictions made at ``steps`` (default: eight spread over
    the run) dashed over the closed-loop vx and e_y. ``log`` comes from
    ``closed_loop(..., log_predictions=True)`` for one car."""
    plt = _pyplot()
    X, P_ = _np(log.X), _np(log.X_pred)             # (T, nx), (T, N+1, nx)
    T, N1, _ = P_.shape
    ey_i = 5 if cfg.model == "dynamic" else 3
    if steps is None:
        steps = list(range(0, T - 1, max(1, T // 8)))
    t = np.arange(T) * cfg.dt

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    ax1.plot(t, X[:, 0], "k-", lw=1.5, label="closed loop vx")
    ax2.plot(t, X[:, ey_i], "k-", lw=1.5, label="closed loop e_y")
    for s0 in steps:
        tp = (s0 + np.arange(N1)) * cfg.dt
        ax1.plot(tp, P_[s0, :, 0], "--", lw=0.9, alpha=0.7)
        ax2.plot(tp, P_[s0, :, ey_i], "--", lw=0.9, alpha=0.7)
    ax1.set_ylabel("vx [m/s]")
    ax1.legend()
    ax1.grid(alpha=0.3)
    ax2.set_ylabel("e_y [m]")
    ax2.set_xlabel("t [s]")
    ax2.legend()
    ax2.grid(alpha=0.3)
    fig.suptitle("MPC predictions (dashed) vs closed loop (solid)")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig


def animate_run(cfg: MPCConfig, track: Track, log, path: str, stride: int = 3, fps: int = 20):
    """Car-on-track animation of one car's log, saved as a GIF at ``path``."""
    plt = _pyplot()
    import matplotlib.animation as animation

    X = _np(log.X)
    s_i = 4 if cfg.model == "dynamic" else 2
    ey_i = 5 if cfg.model == "dynamic" else 3
    gx, gy, _ = _to_global(track, X[:, s_i], X[:, ey_i])

    fig, ax = plt.subplots(figsize=(7, 6))
    plot_track(track, ax)
    trail, = ax.plot([], [], "-", lw=1.0, color="tab:blue")
    car, = ax.plot([], [], "o", ms=6, color="tab:red")
    idx = np.arange(0, X.shape[0], stride)

    def frame(i):
        k = idx[i]
        trail.set_data(gx[:k + 1], gy[:k + 1])
        car.set_data([gx[k]], [gy[k]])
        return trail, car

    ani = animation.FuncAnimation(fig, frame, frames=len(idx), blit=True)
    ani.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path
