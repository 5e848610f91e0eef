"""Online friction adaptation (the JAX package's ``loop/friction.py``):
recursive least squares on mu from the lateral-dynamics residuals, with
the batch as the leading dim.

Each control period the measured state transition is inverted for the axle
lateral forces; each axle then gives one scalar RLS update of mu-hat
against the magic-formula prediction. The sensitivity dFy/dmu is
``torch.func.grad`` of the port's ``tire_force_pacejka`` (the JAX version
uses ``jax.value_and_grad``). Updates are gated on |dFy/dmu| >=
``min_sensitivity`` * Fz, so straight-line driving leaves mu-hat alone.

:func:`adaptive_closed_loop` closes the loop with model mismatch: the
plant runs at the true friction, the controller on mu-hat.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..core.device import resolve_device
from ..models.dynamics import VX_EPS
from ..models.tires import tire_force_pacejka
from ..track.track import Track

MU_MIN = 0.1
MU_MAX = 1.5


class FrictionState(NamedTuple):
    """Scalar-RLS state per lane."""

    mu: torch.Tensor    # (B,) or () current estimate
    P: torch.Tensor     # RLS covariance, same shape


def friction_init(mu0: float = 1.0, P0: float = 0.25, batch=(), device=None) -> FrictionState:
    """Initial estimate mu0 with covariance P0 per lane, on ``device``
    (``None``: the CUDA card)."""
    kw = dict(dtype=torch.float32, device=resolve_device(device))
    return FrictionState(mu=torch.full(batch, mu0, **kw), P=torch.full(batch, P0, **kw))


def measured_axle_forces(p: VehicleParams, x_prev, x_next, u, dt):
    """Invert the lateral dynamics for the axle forces over one period
    (finite-differenced rates, midpoint state). States (..., 6), u (..., 2).
    Returns (fyf, fyr, alpha_f, alpha_r)."""
    delta = u[..., 0]
    x_mid = 0.5 * (x_prev + x_next)
    vx, vy, wz = x_mid[..., 0], x_mid[..., 1], x_mid[..., 2]
    vy_dot = (x_next[..., 1] - x_prev[..., 1]) / dt
    wz_dot = (x_next[..., 2] - x_prev[..., 2]) / dt

    y1 = p.m * (vy_dot + wz * vx)      # = fyf*cos(delta) + fyr
    y2 = p.Iz * wz_dot                 # = lf*fyf*cos(delta) - lr*fyr
    L = p.lf + p.lr
    cd = torch.cos(delta)
    cdg = torch.where(torch.abs(cd) < 0.1, torch.full_like(cd, 0.1), cd)
    fyf = (p.lr * y1 + y2) / (L * cdg)
    fyr = (p.lf * y1 - y2) / L

    vx_safe = torch.clamp_min(vx, VX_EPS)
    alpha_f = delta - torch.atan2(vy + p.lf * wz, vx_safe)
    alpha_r = -torch.atan2(vy - p.lr * wz, vx_safe)
    return fyf, fyr, alpha_f, alpha_r


def friction_step(p: VehicleParams, st: FrictionState, x_prev, x_next, u, dt: float,
                  forgetting: float = 0.995, min_sensitivity: float = 0.05) -> FrictionState:
    """One RLS update of mu-hat from one measured state transition: the
    front then the rear axle as sequential scalar updates."""
    fyf_m, fyr_m, alpha_f, alpha_r = measured_axle_forces(p, x_prev, x_next, u, dt)
    L = p.lf + p.lr
    fzf = p.m * p.g * p.lr / L          # base loads, without mu
    fzr = p.m * p.g * p.lf / L

    mu, P = st.mu, st.P
    for y, alpha, stiffness, fz in ((fyf_m, alpha_f, p.Cf, fzf), (fyr_m, alpha_r, p.Cr, fzr)):
        def h_axle(m):
            h = tire_force_pacejka(alpha, stiffness, m * fz)
            return h.sum(), h
        J, h = torch.func.grad(h_axle, has_aux=True)(mu)
        gate = torch.abs(J) >= min_sensitivity * fz
        S = forgetting + J * P * J
        K = P * J / S
        mu2 = torch.clamp(mu + K * (y - h), MU_MIN, MU_MAX)
        P2 = (P - K * J * P) / forgetting
        mu, P = torch.where(gate, mu2, mu), torch.where(gate, P2, P)
    return FrictionState(mu=mu, P=P)


class AdaptiveLog(NamedTuple):
    X: torch.Tensor          # (T, nx) plant states (T, B, nx) for a batch
    U: torch.Tensor          # (T, nu)
    mu_hat: torch.Tensor     # (T,) friction estimate after each step
    converged: torch.Tensor  # (T,)


def adaptive_closed_loop(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                         x0: torch.Tensor, x_ref, T: int, mu_true: float, mu0: float = 1.0,
                         sim_tire: str = "pacejka", n_sub: int = 10, forgetting: float = 0.995,
                         adapt: bool = True) -> AdaptiveLog:
    """Closed loop with model mismatch: the plant runs at ``mu_true`` while
    the controller starts at ``mu0`` and, with ``adapt=True``, schedules its
    LPV stages and friction-circle speed caps on the RLS mu-hat every step.
    ``adapt=False`` is the ablation: the same loop with the estimate logged
    but not used. ``x0`` is one car's state (nx,) as in the JAX package, or
    a batch (B, nx); the log has the same leading dims."""
    from .closed_loop import plant_step
    from .mpc import mpc_init, mpc_step_batched

    if cfg.model != "dynamic":
        raise ValueError("friction adaptation needs the dynamic model "
                         "(kinematic has no lateral-force channel)")
    single = x0.dim() == 1
    x = x0[None] if single else x0
    B = x.shape[0]
    mu0 = float(torch.tensor(mu0, dtype=torch.float32))      # the JAX package's f32 mu0
    p_plant = p.replace(mu=float(torch.tensor(mu_true, dtype=torch.float32)))
    carry = mpc_init(p.replace(mu=mu0), cfg, track, x)
    fst = friction_init(mu0, batch=(B,), device=x.device)
    outs = []
    for _ in range(T):
        p_hat = p.replace(mu=fst.mu) if adapt else p.replace(mu=mu0)
        u, carry, diag = mpc_step_batched(p_hat, cfg, scfg, track, x, x_ref, carry)
        x_next = plant_step(p_plant, cfg, track, x, u, n_sub=n_sub, sim_tire=sim_tire)
        fst = friction_step(p, fst, x, x_next, u, cfg.dt, forgetting=forgetting)
        x = x_next
        outs.append((x, u, fst.mu, diag.converged))
    log = AdaptiveLog(*(torch.stack(col) for col in zip(*outs)))
    return AdaptiveLog(*(t[:, 0] for t in log)) if single else log
