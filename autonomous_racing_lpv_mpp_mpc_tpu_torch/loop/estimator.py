"""State estimation (the JAX package's ``loop/estimator.py``): the noisy
sensor model and the extended Kalman filter over the nonlinear Frenet
bicycle, with the batch as the leading dim.

The EKF's predict integrates the plant model at ``dt / n_sub`` (fine
Euler, like the plant); its transition Jacobian is ``torch.func.jacfwd`` of
that sub-stepped map, per lane under ``torch.func.vmap`` (the JAX version
uses ``jax.jacfwd``). Curvature enters through the table lookup, whose
index has no gradient, so both sides treat it as constant within a
sub-step; the port reads it on a batched forward pass and hands it in.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.config import MPCConfig, VehicleParams, broadcast_params
from ..models import f_model, model_nx
from ..track.track import Track, curvature_at

# Process-noise variances for the dynamic model (vx, vy, wz, e_psi, s, e_y):
# the velocity channels carry the force-model error of an unknown mu.
DEFAULT_EKF_Q = (1e-3, 1e-3, 5e-3, 1e-4, 1e-4, 1e-4)


def passthrough(x: torch.Tensor) -> torch.Tensor:
    """The identity estimator: the measured state is the estimate."""
    return x


def noisy_measurement(x: torch.Tensor, sigma, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Simulated sensor: state + Gaussian noise with per-state sigma, drawn
    from ``generator`` (a ``torch.Generator`` on ``x``'s device)."""
    sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
    return x + sigma * torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


class EKFState(NamedTuple):
    x: torch.Tensor    # (B, nx) mean
    P: torch.Tensor    # (B, nx, nx) covariance


def ekf_init(x0: torch.Tensor, p0: float = 0.1) -> EKFState:
    """Filter state at the initial states x0 (B, nx) or (nx,)."""
    n = x0.shape[-1]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    return EKFState(x=x0, P=(p0 * eye).expand(x0.shape[:-1] + (n, n)).clone())


def _lane_params(p: VehicleParams, batch, device) -> dict:
    """Every vehicle parameter as a (B,) tensor, for ``vmap``: a float
    leaf is filled on the device, with no host-to-device copy, so the step
    can be captured in a CUDA graph."""
    def lane(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32).expand(batch)
        return torch.full(batch, float(v), dtype=torch.float32, device=device)

    return {f.name: lane(getattr(p, f.name)) for f in dataclasses.fields(VehicleParams)}


def ekf_step(
    p: VehicleParams,
    cfg: MPCConfig,
    track: Track,
    st: EKFState,
    u: torch.Tensor,
    z: torch.Tensor,
    Q: torch.Tensor,
    R: torch.Tensor,
    H: Optional[torch.Tensor] = None,
    n_sub: int = 4,
    gate_sigma: float = 0.0,
) -> EKFState:
    """One predict + update cycle at the control period for every lane.

    ``st.x`` (B, nx), ``st.P`` (B, nx, nx), ``u`` (B, nu), ``z`` (B, m);
    ``Q`` (nx, nx) and ``R`` (m, m) shared; ``p`` leaves floats or (B,)
    tensors. ``gate_sigma > 0`` inflates R on every channel whose innovation
    exceeds ``gate_sigma * sqrt(S_ii)``, so a one-frame glitch barely
    updates the filter."""
    nx = model_nx(cfg.model)
    s_idx = 4 if cfg.model == "dynamic" else 2
    x0 = st.x
    kw = dict(dtype=x0.dtype, device=x0.device)
    if H is None:
        H = torch.eye(nx, **kw)
    h = cfg.dt / n_sub

    # the curvature of each sub-step's cell: a table lookup, constant for
    # the Jacobian, read on the batched forward pass
    pb = broadcast_params(p, 1)
    ub = u.expand(x0.shape[:1] + u.shape[-1:])
    kaps, xb = [], x0
    for _ in range(n_sub):
        kaps.append(curvature_at(track, xb[:, s_idx]))
        xb = xb + h * f_model(pb, xb, ub, kaps[-1], cfg.model, cfg.tire)

    def step_fn(x, u_l, kap_l, pv):
        pl = VehicleParams(**pv)
        for i in range(n_sub):
            x = x + h * f_model(pl, x, u_l, kap_l[i], cfg.model, cfg.tire)
        return x, x

    pv = _lane_params(p, x0.shape[:1], x0.device)
    F, x_pred = torch.func.vmap(torch.func.jacfwd(step_fn, has_aux=True))(
        x0, ub, torch.stack(kaps, dim=-1), pv)
    F = F.to(x0.dtype)   # the per-lane jvp may widen the tangents
    P_pred = F @ st.P @ F.transpose(-1, -2) + Q

    nu = z - x_pred @ H.T
    S = H @ P_pred @ H.T + R
    if gate_sigma > 0.0:
        S0d = torch.diagonal(S, dim1=-2, dim2=-1)
        outlier = torch.abs(nu) > gate_sigma * torch.sqrt(S0d)
        S = S + torch.diag_embed(torch.where(outlier, 1e6 * S0d, torch.zeros_like(S0d)))
    PHt = P_pred @ H.T
    # solve_ex: no host read of the factorization's status (JAX's solve
    # raises on no singular S either), so the step is graph-capturable
    K = torch.linalg.solve_ex(S.transpose(-1, -2), PHt.transpose(-1, -2))[0].transpose(-1, -2)
    x_new = x_pred + (K @ nu[..., None])[..., 0]
    P_new = (torch.eye(nx, **kw) - K @ H) @ P_pred
    return EKFState(x=x_new, P=0.5 * (P_new + P_new.transpose(-1, -2)))
