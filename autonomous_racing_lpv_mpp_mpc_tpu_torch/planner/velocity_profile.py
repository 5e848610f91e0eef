"""Friction-limited velocity profile along the track centerline (the JAX
package's ``planner/velocity_profile.py``):

1. curvature speed limit   v_lim(s) = sqrt(a_lat_frac * mu * g / |kappa(s)|)
2. forward pass            v[i+1] <= sqrt(v[i]^2 + 2 a_max ds)     (accel)
3. backward pass           v[i]   <= sqrt(v[i+1]^2 + 2 |a_min| ds) (braking)

made periodic by running the passes over two laps and keeping the second.
Each pass is a sequential recurrence over the track grid (1,590 cells on
the racetrack, 3,180 over two laps); on the card that would be thousands of
one-element launches per pass. It runs on the host instead, in float32
with the JAX scans' operations in their order, from the track's speed-limit
table, and the (n,) result goes to the track's device once: a per-plan
precomputation of a few KB, read by the planner's initial guess and its
fallback table cells.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import MPCBounds, VehicleParams
from ..engine.assembly import curvature_speed_limit_table
from ..track.track import Track


def curvature_speed_limit(p: VehicleParams, track: Track, bounds: MPCBounds,
                          a_lat_frac: float = 0.85) -> torch.Tensor:
    """(n,) per-cell speed limit from the friction circle."""
    return curvature_speed_limit_table(p, track, bounds.vx_min, bounds.vx_max, a_lat_frac)


def _pass(caps: np.ndarray, v0: np.float32, inc: np.float32, reverse: bool) -> np.ndarray:
    """v = min(cap, sqrt(v_prev^2 + inc)) along caps (backwards when
    ``reverse``), from the carry v0; float32 throughout."""
    out = np.empty_like(caps)
    v = v0
    order = range(caps.shape[0] - 1, -1, -1) if reverse else range(caps.shape[0])
    for i in order:
        v = min(caps[i], np.sqrt(v * v + inc))
        out[i] = v
    return out


def velocity_profile(p: VehicleParams, track: Track, bounds: MPCBounds, a_lat_frac: float = 0.85,
                     a_long_frac: float = 0.9) -> torch.Tensor:
    """(n,) periodic friction- and accel-limited velocity profile on the
    track grid, on the track's device."""
    v_lim = curvature_speed_limit(p, track, bounds, a_lat_frac)
    caps = v_lim.detach().cpu().numpy().astype(np.float32)
    ds = np.float32(track.ds_host)
    inc_acc = np.float32(2 * (a_long_frac * bounds.a_max)) * ds
    inc_brk = np.float32(2 * (a_long_frac * abs(bounds.a_min))) * ds
    v2 = np.concatenate([caps, caps])
    vf = _pass(v2, v2[-1], inc_acc, reverse=False)
    vb = _pass(np.minimum(v2, vf), vf[0], inc_brk, reverse=True)
    vf2 = _pass(np.minimum(v2, vb), vb[-1], inc_acc, reverse=False)
    vb2 = _pass(np.minimum(v2, vf2), vf2[0], inc_brk, reverse=True)
    return torch.from_numpy(vb2[caps.shape[0]:].copy()).to(v_lim.device)
