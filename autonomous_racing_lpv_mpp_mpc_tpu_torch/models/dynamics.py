"""Nonlinear bicycle dynamics in Frenet coordinates (the JAX package's
``models/dynamics.py``).

- dynamic   (nx=6): x = (vx, vy, wz, e_psi, s, e_y)
- kinematic (nx=4): x = (vx, e_psi, s, e_y)
- inputs    (nu=2): u = (delta, a)

States are the LAST axis, any leading batch dims; ``kappa`` has the leading
shape. Batched :class:`VehicleParams` leaves must already broadcast against
that leading shape (``core.config.broadcast_params``).
"""

from __future__ import annotations

import torch

from ..core.config import VehicleParams
from .tires import axle_loads, tire_force

DYN_NX = 6
KIN_NX = 4
NU = 2

# scheduling floor on vx (the LPV divides by vx; the plant's slip angles
# are guarded the same way)
VX_EPS = 0.05
# floor on the Frenet denominator 1 - kappa*e_y
DENOM_EPS = 0.1


def frenet_denom(kappa, ey):
    return torch.clamp_min(1.0 - kappa * ey, DENOM_EPS)


def f_dynamic(p: VehicleParams, x, u, kappa, tire: str = "linear"):
    """Continuous-time dynamic-bicycle Frenet ODE, dx/dt."""
    vx, vy, wz, epsi, ey = x[..., 0], x[..., 1], x[..., 2], x[..., 3], x[..., 5]
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

    se, ce = torch.sin(epsi), torch.cos(epsi)
    denom = frenet_denom(kappa, ey)
    sdot = (vx * ce - vy * se) / denom
    depsi = wz - kappa * sdot
    dey = vx * se + vy * ce
    return torch.stack([dvx, dvy, dwz, depsi, sdot, dey], dim=-1)


def f_kinematic(p: VehicleParams, x, u, kappa, tire: str = "linear"):
    """Continuous-time kinematic-bicycle Frenet ODE (no tire slip)."""
    del tire
    vx, epsi, ey = x[..., 0], x[..., 1], x[..., 3]
    delta, a = u[..., 0], u[..., 1]
    L = p.lf + p.lr

    dvx = a - (p.cd0 + p.cd1 * vx) / p.m
    psidot = vx * torch.tan(delta) / L
    se, ce = torch.sin(epsi), torch.cos(epsi)
    denom = frenet_denom(kappa, ey)
    sdot = vx * ce / denom
    depsi = psidot - kappa * sdot
    dey = vx * se
    return torch.stack([dvx, depsi, sdot, dey], dim=-1)


def f_model(p: VehicleParams, x, u, kappa, model: str, tire: str = "linear"):
    if model == "dynamic":
        return f_dynamic(p, x, u, kappa, tire)
    if model == "kinematic":
        return f_kinematic(p, x, u, kappa, tire)
    raise ValueError(f"unknown model: {model!r}")


def model_nx(model: str) -> int:
    return {"dynamic": DYN_NX, "kinematic": KIN_NX}[model]
