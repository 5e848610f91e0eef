"""World-frame plant and Frenet estimation (the JAX package's
``loop/global_loop.py``): the plant lives in (vx, vy, wz, X, Y, psi) and
the controller's Frenet state is recovered from it each step, as the
reference recovers it with ``getLocalPosition``; optionally the measured
state is corrupted with Gaussian noise and filtered by the EKF before it
reaches the MPC. States are the last axis, any leading batch dims; vehicle
parameters are floats or tensors that broadcast against the leading shape.

The Frenet-native loop (``closed_loop.py``) is the fast path; this one is
the fidelity path."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..models.dynamics import VX_EPS
from ..models.tires import axle_loads, tire_force
from ..track.track import Track, frenet_to_global, global_to_frenet, global_to_frenet_windowed
from .estimator import ekf_init, ekf_step
from .mpc import mpc_init, mpc_step_batched


class GlobalLog(NamedTuple):
    Xg: torch.Tensor         # (T, B, 6) world plant states (vx, vy, wz, X, Y, psi)
    Xf: torch.Tensor         # (T, B, 6) the Frenet states fed to the MPC
    U: torch.Tensor          # (T, B, 2)
    converged: torch.Tensor  # (T, B)


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


def closed_loop_global(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                       x0_frenet: torch.Tensor, x_ref, T: int, n_sub: int = 10,
                       sim_tire: Optional[str] = None, noise_sigma=None,
                       generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                       use_ekf: bool = False) -> GlobalLog:
    """World-frame plant, Frenet estimate, optional noisy measurement and
    EKF, then the tracker, for T steps of B cars x0_frenet (B, 6), or of
    one car (6,) (the JAX package's form: no batch dim in the log).

    Each step: the Frenet estimate of the world state (windowed around the
    last step's s), plus ``noise_sigma`` (6,) times a standard normal draw;
    the EKF (``use_ekf``) with Q = 1e-4 I and R = diag(sigma^2) (1e-4 I
    without noise); ``mpc_step_batched`` on ``scfg.backend`` (the fused
    kernel for "fused" on the card); the world plant at ``n_sub`` Euler
    sub-steps. The draws come from ``generator`` (a ``torch.Generator``
    on the states' device), or from ``noise`` (T, B, 6) (or (T, 6) for one
    car) when given: standard normal draws made elsewhere."""
    if cfg.model != "dynamic":
        raise ValueError("the world-frame loop runs the dynamic model")
    if x0_frenet.dim() == 1:
        log = closed_loop_global(p, cfg, scfg, track, x0_frenet[None], x_ref, T, n_sub, sim_tire,
                                 noise_sigma, generator, None if noise is None else noise[:, None], use_ekf)
        return GlobalLog(*(t[:, 0] for t in log))
    x0 = x0_frenet.to(torch.float32)
    kw = dict(dtype=torch.float32, device=x0.device)
    B, nx = x0.shape
    Xw, Yw, psiw = frenet_to_global(track, x0[:, 4], x0[:, 5], x0[:, 3])
    xg = torch.stack([x0[:, 0], x0[:, 1], x0[:, 2], Xw, Yw, psiw], dim=-1)
    carry = mpc_init(p, cfg, track, x0)
    ekf = ekf_init(x0)
    sigma = None if noise_sigma is None else torch.as_tensor(noise_sigma, **kw)
    Qn = 1e-4 * torch.eye(nx, **kw)
    Rn = torch.diag(sigma ** 2) if sigma is not None else 1e-4 * torch.eye(nx, **kw)
    u_prev = torch.zeros((B, 2), **kw)
    s_prev = x0[:, 4]
    outs = []
    for t in range(T):
        z = estimate_frenet(track, xg, s_hint=s_prev)
        if sigma is not None:
            draw = noise[t].to(**kw) if noise is not None else torch.randn(z.shape, generator=generator, **kw)
            z = z + sigma * draw
        if use_ekf:
            ekf = ekf_step(p, cfg, track, ekf, u_prev, z, Qn, Rn)
            xf = ekf.x
        else:
            xf = z
        u, carry, diag = mpc_step_batched(p, cfg, scfg, track, xf, x_ref, carry)
        xg = global_plant_step(p, cfg, xg, u, n_sub=n_sub, sim_tire=sim_tire)
        u_prev, s_prev = u, xf[:, 4]
        outs.append((xg, xf, u, diag.converged))
    return GlobalLog(*(torch.stack(col) for col in zip(*outs)))
