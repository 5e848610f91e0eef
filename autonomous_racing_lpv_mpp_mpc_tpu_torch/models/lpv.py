"""Quasi-LPV embedding: nonlinear bicycle -> A(theta) x + B(theta) u (the
JAX package's ``models/lpv.py``).

Slip angles linear in state with 1/vx scheduling, trig of delta and e_psi
frozen at the scheduled value, the sinc embedding for e_y's dependence on
e_psi, and — for the Pacejka tire — the secant stiffness of the magic
formula at the scheduled slip. Leading batch dims are kept:
x_bar (..., nx), u_bar (..., 2), kappa (...) -> A (..., nx, nx), B (..., nx, 2).
"""

from __future__ import annotations

import math

import torch

from ..core.config import VehicleParams
from .dynamics import VX_EPS, frenet_denom
from .tires import axle_loads, tire_force_pacejka


def _sinc(x):
    """sin(x)/x, 1 at 0 (``torch.sinc`` is the normalized sinc)."""
    return torch.sinc(x / math.pi)


def _effective_stiffness(p: VehicleParams, x_bar, u_bar, tire: str):
    """(Cf_eff, Cr_eff): secant cornering stiffness at the scheduled slip;
    (Cf, Cr) for the linear tire."""
    if tire == "linear":
        return p.Cf, p.Cr
    vx, vy, wz = x_bar[..., 0], x_bar[..., 1], x_bar[..., 2]
    delta = u_bar[..., 0]
    vxs = torch.clamp_min(vx, VX_EPS)
    alpha_f = delta - torch.atan2(vy + p.lf * wz, vxs)
    alpha_r = -torch.atan2(vy - p.lr * wz, vxs)
    fzf_mu, fzr_mu = axle_loads(p)
    eps = 1e-4
    af = torch.where(torch.abs(alpha_f) < eps, torch.full_like(alpha_f, eps), alpha_f)
    ar = torch.where(torch.abs(alpha_r) < eps, torch.full_like(alpha_r, eps), alpha_r)
    cf = tire_force_pacejka(af, p.Cf, fzf_mu) / af
    cr = tire_force_pacejka(ar, p.Cr, fzr_mu) / ar
    return cf, cr


def lpv_ab_dynamic(p: VehicleParams, x_bar, u_bar, kappa, tire: str = "linear"):
    """Continuous-time (A, B) for the dynamic bicycle at the scheduling point."""
    vx, vy, wz, epsi, ey = (x_bar[..., i] for i in (0, 1, 2, 3, 5))
    delta = u_bar[..., 0]
    Cf, Cr = _effective_stiffness(p, x_bar, u_bar, tire)
    vxs = torch.clamp_min(vx, VX_EPS)
    sd, cd = torch.sin(delta), torch.cos(delta)
    se, ce = torch.sin(epsi), torch.cos(epsi)
    denom = frenet_denom(kappa, ey)
    z = torch.zeros_like(vx)
    one = torch.ones_like(vx)
    full = lambda v: v + z      # broadcast a (possibly scalar) entry

    a00 = -(p.cd1 + p.cd0 / vxs) / p.m
    a01 = Cf * sd / (p.m * vxs) + wz
    a02 = Cf * p.lf * sd / (p.m * vxs)
    a11 = -(Cf * cd + Cr) / (p.m * vxs)
    a12 = (-Cf * p.lf * cd + Cr * p.lr) / (p.m * vxs) - vxs
    a21 = (-p.lf * Cf * cd + p.lr * Cr) / (p.Iz * vxs)
    a22 = -(p.lf ** 2 * Cf * cd + p.lr ** 2 * Cr) / (p.Iz * vxs)
    a30 = -kappa * ce / denom
    a31 = kappa * se / denom
    a40 = ce / denom
    a41 = -se / denom
    a51 = ce
    a53 = vxs * _sinc(epsi)
    A = torch.stack([
        torch.stack([full(a00), a01, a02, z, z, z], dim=-1),
        torch.stack([z, a11, a12, z, z, z], dim=-1),
        torch.stack([z, a21, a22, z, z, z], dim=-1),
        torch.stack([a30, a31, one, z, z, z], dim=-1),
        torch.stack([a40, a41, z, z, z, z], dim=-1),
        torch.stack([z, a51, z, a53, z, z], dim=-1),
    ], dim=-2)
    b00 = -Cf * sd / p.m
    b10 = Cf * cd / p.m
    b20 = p.lf * Cf * cd / p.Iz
    B = torch.stack([
        torch.stack([b00, one], dim=-1),
        torch.stack([b10, z], dim=-1),
        torch.stack([b20, z], dim=-1),
        torch.stack([z, z], dim=-1),
        torch.stack([z, z], dim=-1),
        torch.stack([z, z], dim=-1),
    ], dim=-2)
    return A, B


def lpv_ab_kinematic(p: VehicleParams, x_bar, u_bar, kappa):
    """Continuous-time (A, B) for the kinematic bicycle."""
    del u_bar
    vx, epsi, ey = x_bar[..., 0], x_bar[..., 1], x_bar[..., 3]
    vxs = torch.clamp_min(vx, VX_EPS)
    L = p.lf + p.lr
    se, ce = torch.sin(epsi), torch.cos(epsi)
    denom = frenet_denom(kappa, ey)
    z = torch.zeros_like(vx)
    one = torch.ones_like(vx)
    a00 = -(p.cd1 + p.cd0 / vxs) / p.m + z
    A = torch.stack([
        torch.stack([a00, z, z, z], dim=-1),
        torch.stack([-kappa * ce / denom, z, z, z], dim=-1),
        torch.stack([ce / denom, z, z, z], dim=-1),
        torch.stack([z, vxs * _sinc(epsi), z, z], dim=-1),
    ], dim=-2)
    B = torch.stack([
        torch.stack([z, one], dim=-1),
        torch.stack([vxs / L, z], dim=-1),
        torch.stack([z, z], dim=-1),
        torch.stack([z, z], dim=-1),
    ], dim=-2)
    return A, B


def lpv_ab(p: VehicleParams, x_bar, u_bar, kappa, model: str, tire: str = "linear"):
    if model == "dynamic":
        return lpv_ab_dynamic(p, x_bar, u_bar, kappa, tire)
    if model == "kinematic":
        return lpv_ab_kinematic(p, x_bar, u_bar, kappa)
    raise ValueError(f"unknown model: {model!r}")
