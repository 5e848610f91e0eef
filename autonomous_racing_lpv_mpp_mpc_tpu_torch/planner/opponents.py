"""Opponent cars as moving obstacles (the JAX package's
``planner/opponents.py``).

Each opponent follows the track at its own lateral offset and speed. Its
swept footprint until the next replan becomes a Frenet corridor block
``[s_lo, s_hi, ey_lo, ey_hi]`` that the tracker's e_y row avoids
(``engine.assembly.corridor_from_blocks``). Blocks that sweep across the
start/finish line are split in two, because the corridor test is plain
interval containment on the wrapped s.

The blocks are host data: :func:`sweep_blocks`, :func:`pad_blocks` and the
function :func:`opponents_obstacle_fn` returns work in numpy, as in the JAX
package, and a consumer moves them to its device once per segment. The
opponent set and the traces are tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..track.track import Track, wrap_s


class OpponentSet(NamedTuple):
    s0: torch.Tensor    # (n,) arc-length position at t=0 [m]
    e_y: torch.Tensor   # (n,) lateral offset (held constant) [m]
    v: torch.Tensor     # (n,) speed along the centerline [m/s]


def opponents(s0, e_y, v, device=None) -> OpponentSet:
    """An :class:`OpponentSet` of float32 tensors on ``device`` (``None``:
    the CUDA card)."""
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return OpponentSet(f32(s0), f32(e_y), f32(v))


def opponent_s_at(track: Track, opp: OpponentSet, t_s) -> torch.Tensor:
    """(n,) wrapped arc-length positions at time ``t_s`` seconds."""
    return wrap_s(track, opp.s0 + opp.v * t_s)


def sweep_blocks(
    track: Track,
    opp: OpponentSet,
    t0_s: float,
    t1_s: float,
    car_length: float = 0.4,
    car_width: float = 0.2,
    pad: float = 0.05,
    ego_length: float = 0.0,
    ego_width: float = 0.0,
) -> np.ndarray:
    """(m, 4) float32 corridor blocks covering each opponent's swept
    footprint over [t0, t1] (wrap-split, hence m >= n).

    ``ego_length``/``ego_width`` inflate the blocks by the ego's
    half-dimensions, so that a block keeps the ego's CENTER out (two
    rectangles overlap iff their centers are closer than the sum of their
    half-dimensions)."""
    L = float(track.length)
    s_a = opponent_s_at(track, opp, t0_s).cpu().numpy()
    ds = opp.v.cpu().numpy() * max(0.0, t1_s - t0_s)
    ey = opp.e_y.cpu().numpy()
    half_l = (car_length + ego_length) / 2 + pad
    half_w = (car_width + ego_width) / 2 + pad

    rows = []
    for i in range(s_a.shape[0]):
        # ordered by endpoint, so that a reversing opponent (v < 0) blocks
        # the arc it actually sweeps and not its complement
        s_end = s_a[i] + ds[i]
        lo_un = min(s_a[i], s_end) - half_l
        hi_un = max(s_a[i], s_end) + half_l
        lo = lo_un % L
        hi = hi_un % L
        band = (ey[i] - half_w, ey[i] + half_w)
        if hi_un - lo_un >= L:
            rows.append((0.0, L, *band))        # the sweep covers the whole lap
        elif lo <= hi:
            rows.append((lo, hi, *band))
        else:                                    # crosses the finish line
            rows.append((lo, L, *band))
            rows.append((0.0, hi, *band))
    return np.asarray(rows, dtype=np.float32).reshape(-1, 4)


# padding row that never contains a wrapped arc length: s0 > s1 makes the
# interval test (sm >= s0) & (sm <= s1) false everywhere
DUMMY_BLOCK = (1.0, 0.0, 0.0, 0.0)


def pad_blocks(blocks, n_rows: int) -> np.ndarray:
    """(m, 4) corridor blocks padded to a fixed (n_rows, 4) with inert dummy
    rows, so that a consumer sees one shape as obstacles move, appear and
    go between segments."""
    out = np.tile(np.asarray(DUMMY_BLOCK, np.float32), (n_rows, 1))
    if blocks is not None:
        b = np.asarray(blocks, np.float32).reshape(-1, 4)
        if b.shape[0] > n_rows:
            raise ValueError(f"{b.shape[0]} obstacle blocks exceed max_obstacle_rows={n_rows}")
        out[: b.shape[0]] = b
    return out


def opponents_obstacle_fn(
    track: Track,
    opp: OpponentSet,
    dt: float,
    replan_every: int,
    car_length: float = 0.4,
    car_width: float = 0.2,
    pad: float = 0.05,
    t_lead: float = 0.3,
    ego_length: float = 0.3,
    ego_width: float = 0.15,
) -> Callable[[int], Optional[np.ndarray]]:
    """``obstacles_fn(step)``: at control step ``step`` the blocks sweep each
    opponent from now until the next replan plus ``t_lead`` seconds (the
    tracker follows a line with lag, so the manoeuvre must be under way
    before the corridor requires clearance). The blocks are inflated by the
    ego's half-dimensions and so bound the ego's center, matching
    :func:`collision_trace`. Returns a numpy (m, 4) array, or None when
    there is no opponent."""

    def fn(step: int) -> Optional[np.ndarray]:
        t0 = step * dt
        t1 = (step + replan_every) * dt + t_lead
        blocks = sweep_blocks(track, opp, t0, t1, car_length, car_width, pad, ego_length, ego_width)
        return blocks if blocks.size else None

    return fn


def _frenet_gaps(track: Track, opp: OpponentSet, X_ego: torch.Tensor, dt: float, s_idx: int,
                 ey_idx: int):
    """(|ds|, |de_y|), each (..., T, n): the wrap-aware arc-length and the
    lateral distance from the ego at step t (time t dt) to each opponent."""
    T = X_ego.shape[-2]
    t = torch.arange(T, dtype=torch.float32, device=X_ego.device) * dt
    s_opp = wrap_s(track, opp.s0[None, :] + opp.v[None, :] * t[:, None])    # (T, n)
    s_ego = wrap_s(track, X_ego[..., s_idx])
    ds = torch.abs(s_opp - s_ego[..., None])
    ds = torch.minimum(ds, track.length - ds)
    dey = torch.abs(opp.e_y - X_ego[..., ey_idx][..., None])
    return ds, dey


def collision_trace(
    track: Track,
    opp: OpponentSet,
    X_ego: torch.Tensor,
    dt: float,
    ego_length: float = 0.3,
    ego_width: float = 0.15,
    opp_length: float = 0.3,
    opp_width: float = 0.15,
    s_idx: int = 4,
    ey_idx: int = 5,
) -> torch.Tensor:
    """(..., T) bool: the ego's Frenet rectangle overlaps ANY opponent's at
    step t. ``X_ego`` (..., T, nx) holds ego states, a leading batch of
    cars allowed."""
    ds, dey = _frenet_gaps(track, opp, X_ego, dt, s_idx, ey_idx)
    hit = (ds < (ego_length + opp_length) / 2) & (dey < (ego_width + opp_width) / 2)
    return torch.any(hit, dim=-1)


def min_gap_trace(
    track: Track,
    opp: OpponentSet,
    X_ego: torch.Tensor,
    dt: float,
    s_idx: int = 4,
    ey_idx: int = 5,
) -> torch.Tensor:
    """(..., T) distance from the ego to the nearest opponent at each step
    (wrap-aware delta-s and delta-e_y, Euclidean norm)."""
    ds, dey = _frenet_gaps(track, opp, X_ego, dt, s_idx, ey_idx)
    return torch.amin(torch.sqrt(ds * ds + dey * dey), dim=-1)
