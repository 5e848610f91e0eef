"""Lap-over-lap reference learning (the JAX package's
``loop/lap_learning.py``). Only the seed table is ported so far; the
learning update and the lap-learning loops come with the planner."""

from __future__ import annotations

import torch

from ..planner.reftable import RefTable
from ..track.track import Track


def initial_table(track: Track, ds: float = 0.05, vx0: float = 1.0) -> RefTable:
    """Conservative flat-speed centerline table to seed the learner."""
    L = float(track.length)
    n = max(int(round(L / ds)), 8)
    kw = dict(dtype=torch.float32, device=track.kappa.device)
    return RefTable(
        ds=torch.tensor(L / n, **kw),
        length=torch.tensor(L, **kw),
        vx=torch.full((n,), vx0, **kw),
        ey=torch.zeros((n,), **kw),
        delta=torch.zeros((n,), **kw),
    )
