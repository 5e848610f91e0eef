"""Horizon scheduling + block-structured QP assembly (the JAX package's
``engine/assembly.py``), with the batch written out as the leading dim.

Delta-u costs and rate bounds are made stage-separable by augmenting the
state with the previous control, xa_k = (x_k, u_{k-1}). Constraint rows per
stage (nc = 6): vx box, e_y corridor (soft), delta box, a box, Delta-delta
box, Delta-a box. Obstacle corridors are not ported yet.

Shapes: x0 (B, nx), u_prev (B, nu), X_sched (B, N+1, nx), U_sched (B, N, nu),
x_ref (N+1, nx) shared or (B, N+1, nx). Vehicle params are floats or (B,)
tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.config import MPCConfig, VehicleParams, broadcast_params
from ..core.device import resolve_device
from ..models import discretize, lpv_ab, model_nx
from ..models.dynamics import NU, f_model
from ..solver.admm import BoxQP
from ..solver.riccati import LQRCost, LQRDynamics
from ..track.track import Track, _cell_index, curvature_at

N_CON = 6  # constraint rows per stage


def state_indices(model: str) -> Tuple[int, int]:
    """(vx_idx, ey_idx) in the model's state vector."""
    if model == "dynamic":
        return 0, 5
    if model == "kinematic":
        return 0, 3
    raise ValueError(model)


def _s_index(model: str) -> int:
    return 4 if model == "dynamic" else 2


def shift_schedule(X_prev: torch.Tensor, U_prev: torch.Tensor):
    """Shift the previous solution one stage (axis -2), repeating the last."""
    X = torch.cat([X_prev[..., 1:, :], X_prev[..., -1:, :]], dim=-2)
    U = torch.cat([U_prev[..., 1:, :], U_prev[..., -1:, :]], dim=-2)
    return X, U


def initial_schedule(p: VehicleParams, cfg: MPCConfig, track: Track,
                     x0: torch.Tensor, u0: torch.Tensor):
    """Constant-input Euler rollout used before a first solution exists."""
    pb = broadcast_params(p, 1)
    xs = [x0]
    x = x0
    for _ in range(cfg.N):
        kap = curvature_at(track, x[..., _s_index(cfg.model)])
        x = x + cfg.dt * f_model(pb, x, u0, kap, cfg.model, cfg.tire)
        xs.append(x)
    X = torch.stack(xs, dim=-2)
    U = u0.unsqueeze(-2).expand(u0.shape[:-1] + (cfg.N, u0.shape[-1])).clone()
    return X, U


def speed_cap_at(p: VehicleParams, track: Track, s, vx_min, vx_max,
                 a_lat_frac: float = 0.85):
    """Friction-circle speed cap sqrt(f mu g / |kappa|) at the cell of s."""
    kap = torch.abs(track.kappa[_cell_index(track, s)])
    v_lim = torch.sqrt(a_lat_frac * p.mu * p.g / torch.clamp_min(kap, 1e-6))
    return torch.clamp(v_lim, vx_min, vx_max)


def augment_dynamics(Ad, Bd, cd):
    """(A, B, c) on x -> on xa = (x, u_prev): the stage-separable form."""
    nx, nu = Bd.shape[-2], Bd.shape[-1]
    na = nx + nu
    lead = Ad.shape[:-2]
    kw = dict(dtype=Ad.dtype, device=Ad.device)
    Aa = torch.zeros(lead + (na, na), **kw)
    Aa[..., :nx, :nx] = Ad
    Ba = torch.zeros(lead + (na, nu), **kw)
    Ba[..., :nx, :] = Bd
    Ba[..., nx:, :] = torch.eye(nu, **kw)
    ca = torch.zeros(lead + (na,), **kw)
    ca[..., :nx] = cd
    return Aa, Ba, ca


def constraint_rows(model: str, dtype=torch.float32, device=None):
    """The 6 standard rows on (xa, u): vx, e_y, delta, a, Ddelta, Da, on
    ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    nx = model_nx(model)
    na = nx + NU
    vx_i, ey_i = state_indices(model)
    Dx = torch.zeros((N_CON, na), dtype=dtype, device=device)
    Du = torch.zeros((N_CON, NU), dtype=dtype, device=device)
    Dx[0, vx_i] = 1.0
    Dx[1, ey_i] = 1.0
    Du[2, 0] = 1.0
    Du[3, 1] = 1.0
    Dx[4, nx + 0] = -1.0
    Du[4, 0] = 1.0
    Dx[5, nx + 1] = -1.0
    Du[5, 1] = 1.0
    return Dx, Du


def scheduled_stages(p, cfg, track, X_sched, U_sched):
    """LPV stage matrices along the scheduling trajectory: (B, N, ...)."""
    if cfg.linearization != "lpv":
        raise NotImplementedError("only the LPV linearization is ported (ltv_abc waits)")
    N = X_sched.shape[-2] - 1
    nx = model_nx(cfg.model)
    xk = X_sched[..., :N, :]
    kappas = curvature_at(track, xk[..., _s_index(cfg.model)])
    pb = broadcast_params(p, xk.dim() - 1)
    A, B = lpv_ab(pb, xk, U_sched, kappas, cfg.model, cfg.tire)
    Ad, Bd = discretize(A, B, cfg.dt, method=cfg.discretization)
    cd = torch.zeros(xk.shape[:-1] + (nx,), dtype=X_sched.dtype, device=X_sched.device)
    return Ad, Bd, cd


def tracker_bounds(p: VehicleParams, cfg: MPCConfig, track: Track, X_sched,
                   obstacles=None):
    """(B, N+1, N_CON) stage bounds: standard boxes + per-stage
    friction-circle vx caps; stage-0 state rows and terminal input/rate rows
    disabled."""
    if obstacles is not None:
        raise NotImplementedError("obstacle corridors are not ported yet")
    b = cfg.bounds
    lo = (b.vx_min, -b.ey_max, -b.delta_max, b.a_min, -b.ddelta_max, -b.da_max)
    hi = (b.vx_max, b.ey_max, b.delta_max, b.a_max, b.ddelta_max, b.da_max)
    shape = X_sched.shape[:-1] + (N_CON,)
    # filled on the device column by column: a tensor built from a Python
    # list would be a host-to-device copy, which waits for the device
    lb, ub = X_sched.new_empty(shape), X_sched.new_empty(shape)
    for c in range(N_CON):
        lb[..., c] = lo[c]
        ub[..., c] = hi[c]
    if cfg.kappa_speed_cap:
        pb = broadcast_params(p, X_sched.dim() - 1)
        ub[..., 0] = speed_cap_at(pb, track, X_sched[..., _s_index(cfg.model)],
                                  b.vx_min, b.vx_max, cfg.a_lat_frac)
    inf = float("inf")
    lb[..., 0, :2] = -inf
    ub[..., 0, :2] = inf
    lb[..., -1, 2:] = -inf
    ub[..., -1, 2:] = inf
    return lb, ub


def build_boxqp(
    p: VehicleParams,
    cfg: MPCConfig,
    track: Track,
    x0: torch.Tensor,
    u_prev: torch.Tensor,
    X_sched: torch.Tensor,
    U_sched: torch.Tensor,
    x_ref: torch.Tensor,
    obstacles=None,
) -> BoxQP:
    """Assemble the block-structured MPC QP on the augmented state."""
    if obstacles is not None:
        raise NotImplementedError("obstacle corridors are not ported yet")
    N = cfg.N
    nx = model_nx(cfg.model)
    na = nx + NU
    f32 = dict(dtype=X_sched.dtype, device=X_sched.device)
    lead = X_sched.shape[:-2]

    Ad, Bd, cd = scheduled_stages(p, cfg, track, X_sched, U_sched)
    Aa, Ba, ca = augment_dynamics(Ad, Bd, cd)

    w = cfg.weights
    if len(w.q) != nx:
        raise ValueError(
            f"MPCWeights.q has {len(w.q)} entries but model {cfg.model!r} has "
            f"{nx} states; use MPCWeights.for_model({cfg.model!r})"
        )
    Qd = torch.tensor(w.q, **f32)
    Rd = torch.diag(torch.tensor(w.r, **f32))
    dR = torch.diag(torch.tensor(w.dr, **f32))

    Q1 = torch.zeros((na, na), **f32)
    Q1[:nx, :nx] = torch.diag(Qd)
    Q_stage = Q1.clone()
    Q_stage[nx:, nx:] = dR
    Q = Q_stage.expand(lead + (N + 1, na, na)).clone()
    Q[..., N, :, :] = Q1
    R = (Rd + dR).expand(lead + (N, NU, NU)).clone()
    M_stage = torch.zeros((na, NU), **f32)
    M_stage[nx:, :] = -dR
    M = M_stage.expand(lead + (N, na, NU)).clone()

    Dx, Du = constraint_rows(cfg.model, **f32)
    lb, ub = tracker_bounds(p, cfg, track, X_sched)
    # clamp the vx reference to the per-stage friction cap
    x_ref = x_ref.expand(lead + (N + 1, nx)).clone()
    x_ref[..., 0] = torch.minimum(x_ref[..., 0], ub[..., 0])
    qlin = torch.zeros(lead + (N + 1, na), **f32)
    qlin[..., :nx] = -(x_ref * Qd)
    rlin = torch.zeros(lead + (N, NU), **f32)

    soft = torch.full((N_CON,), float("inf"), **f32)
    soft[1] = cfg.bounds.ey_soft

    xa0 = torch.cat([x0, u_prev], dim=-1)
    return BoxQP(
        dyn=LQRDynamics(Aa, Ba, ca),
        cost=LQRCost(Q, qlin, R, rlin, M),
        Dx=Dx, Du=Du, lb=lb, ub=ub, x0=xa0, soft=soft,
    )
