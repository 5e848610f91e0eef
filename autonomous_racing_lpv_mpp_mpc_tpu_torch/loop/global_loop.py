"""World-frame plant and Frenet estimation (the JAX package's
``loop/global_loop.py``): the plant lives in (vx, vy, wz, X, Y, psi) and
the controller's Frenet state is recovered from it each step. States are
the last axis, any leading batch dims; vehicle parameters are floats or
tensors that broadcast against the leading shape."""

from __future__ import annotations

import torch

from ..core.config import MPCConfig, VehicleParams
from ..models.dynamics import VX_EPS
from ..models.tires import axle_loads, tire_force
from ..track.track import Track, global_to_frenet, global_to_frenet_windowed


def f_global(p: VehicleParams, xg, u, tire: str = "linear"):
    """World-frame dynamic bicycle ODE: xg = (vx, vy, wz, X, Y, psi)."""
    vx, vy, wz, psi = xg[..., 0], xg[..., 1], xg[..., 2], xg[..., 5]
    delta, a = u[..., 0], u[..., 1]
    vx_safe = torch.clamp_min(vx, VX_EPS)
    alpha_f = delta - torch.atan2(vy + p.lf * wz, vx_safe)
    alpha_r = -torch.atan2(vy - p.lr * wz, vx_safe)
    fzf_mu, fzr_mu = axle_loads(p)
    fyf = tire_force(alpha_f, p.Cf, fzf_mu, tire)
    fyr = tire_force(alpha_r, p.Cr, fzr_mu, tire)
    sd, cd = torch.sin(delta), torch.cos(delta)
    dvx = a - (fyf * sd) / p.m + wz * vy - (p.cd0 + p.cd1 * vx) / p.m
    dvy = (fyf * cd + fyr) / p.m - wz * vx
    dwz = (p.lf * fyf * cd - p.lr * fyr) / p.Iz
    dX = vx * torch.cos(psi) - vy * torch.sin(psi)
    dY = vx * torch.sin(psi) + vy * torch.cos(psi)
    return torch.stack([dvx, dvy, dwz, dX, dY, wz], dim=-1)


def global_plant_step(p: VehicleParams, cfg: MPCConfig, xg, u, n_sub: int = 10, sim_tire=None):
    """``n_sub`` fine Euler sub-steps of :func:`f_global` over one period."""
    tire = sim_tire or cfg.tire
    h = cfg.dt / n_sub
    for _ in range(n_sub):
        xg = xg + h * f_global(p, xg, u, tire)
    return xg


def estimate_frenet(track: Track, xg, s_hint=None):
    """World-frame state -> Frenet controller state (vx, vy, wz, e_psi, s, e_y).

    With ``s_hint`` (the previous unwrapped s) the nearest-node search is
    windowed around it and s is re-unwrapped to the hint's lap, so the
    controller sees monotone progress."""
    if s_hint is not None:
        s, ey, epsi = global_to_frenet_windowed(track, xg[..., 3], xg[..., 4], xg[..., 5], s_hint)
        L = track.length
        s = s + torch.round((s_hint - s) / L) * L
    else:
        s, ey, epsi = global_to_frenet(track, xg[..., 3], xg[..., 4], xg[..., 5])
    return torch.stack([xg[..., 0], xg[..., 1], xg[..., 2], epsi, s, ey], dim=-1)
