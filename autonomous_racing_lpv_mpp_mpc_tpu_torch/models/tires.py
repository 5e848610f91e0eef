"""Tire lateral-force models: linear and the simplified Pacejka magic
formula (the JAX package's ``models/tires.py``). Elementwise in torch."""

from __future__ import annotations

import torch

from ..core.config import VehicleParams

# Pacejka shape factor C; B = stiffness / (C D) keeps the small-slip slope
# equal to the linear cornering stiffness.
_PACEJKA_C = 1.3


def tire_force_linear(alpha, stiffness, fz_mu):
    del fz_mu
    return stiffness * alpha


def tire_force_pacejka(alpha, stiffness, fz_mu):
    """Fy = D sin(C atan(B alpha)), D = mu Fz, B = stiffness / (C D)."""
    D = fz_mu
    B = stiffness / (_PACEJKA_C * torch.clamp_min(torch.as_tensor(D), 1e-6))
    return D * torch.sin(_PACEJKA_C * torch.atan(B * alpha))


def tire_force(alpha, stiffness, fz_mu, tire: str):
    if tire == "linear":
        return tire_force_linear(alpha, stiffness, fz_mu)
    if tire == "pacejka":
        return tire_force_pacejka(alpha, stiffness, fz_mu)
    raise ValueError(f"unknown tire model: {tire!r}")


def axle_loads(p: VehicleParams):
    """Static axle normal loads (Fzf, Fzr) scaled by friction mu."""
    L = p.lf + p.lr
    fzf = p.m * p.g * p.lr / L
    fzr = p.m * p.g * p.lf / L
    return p.mu * fzf, p.mu * fzr
