"""Horizon scheduling + block-structured QP assembly (the JAX package's
``engine/assembly.py``), with the batch written out as the leading dim.

Delta-u costs and rate bounds are made stage-separable by augmenting the
state with the previous control, xa_k = (x_k, u_{k-1}). Constraint rows per
stage (nc = 6): vx box, e_y corridor (soft), delta box, a box, Delta-delta
box, Delta-a box. Obstacle blocks tighten the e_y row per stage
(:func:`corridor_from_blocks`, the RAS-2020 obstacle-aware corridor).

Shapes: x0 (B, nx), u_prev (B, nu), X_sched (B, N+1, nx), U_sched (B, N, nu),
x_ref (N+1, nx) shared or (B, N+1, nx). Vehicle params are floats or (B,)
tensors. Obstacle blocks are (n_obs, 4) rows ``[s0, s1, ey_lo, ey_hi]``
shared by the batch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.config import MPCConfig, VehicleParams, broadcast_params
from ..core.device import resolve_device
from ..models import discretize, lpv_ab, ltv_abc, model_nx
from ..models.dynamics import NU, f_model
from ..solver.admm import BoxQP
from ..solver.riccati import LQRCost, LQRDynamics
from ..track.track import Track, _cell_index, curvature_at, wrap_s

N_CON = 6  # constraint rows per stage


def state_indices(model: str) -> Tuple[int, int]:
    """(vx_idx, ey_idx) in the model's state vector."""
    if model == "dynamic":
        return 0, 5
    if model == "kinematic":
        return 0, 3
    raise ValueError(model)


def aug_dim(model: str) -> int:
    """Width of the augmented state (x, u_prev)."""
    return model_nx(model) + NU


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


def curvature_speed_limit_table(p: VehicleParams, track: Track, vx_min, vx_max,
                                a_lat_frac: float = 0.85) -> torch.Tensor:
    """(n_cells,) friction-circle speed limit v <= sqrt(f mu g / |kappa|)
    per track cell, clipped to [vx_min, vx_max]."""
    v_lim = torch.sqrt(a_lat_frac * p.mu * p.g / torch.clamp_min(torch.abs(track.kappa), 1e-6))
    return torch.clamp(v_lim, vx_min, vx_max)


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
    """LPV (or, with ``cfg.linearization == "ltv"``, exact-Jacobian LTV
    with its affine term) stage matrices along the scheduling trajectory:
    (B, N, ...)."""
    N = X_sched.shape[-2] - 1
    nx = model_nx(cfg.model)
    xk = X_sched[..., :N, :]
    kappas = curvature_at(track, xk[..., _s_index(cfg.model)])
    pb = broadcast_params(p, xk.dim() - 1)
    if cfg.linearization == "ltv":
        A, B, c = ltv_abc(pb, xk, U_sched, kappas, cfg.model, cfg.tire)
        return discretize(A, B, cfg.dt, c, method=cfg.discretization)
    if cfg.linearization != "lpv":
        raise ValueError(f"unknown linearization: {cfg.linearization!r}")
    A, B = lpv_ab(pb, xk, U_sched, kappas, cfg.model, cfg.tire)
    Ad, Bd = discretize(A, B, cfg.dt, method=cfg.discretization)
    cd = torch.zeros(xk.shape[:-1] + (nx,), dtype=X_sched.dtype, device=X_sched.device)
    return Ad, Bd, cd


def block_curvatures(track: Track, blocks: torch.Tensor, n_samples: int = 8) -> torch.Tensor:
    """(n_obs,) signed curvature of the sharpest point of each block's core
    (its inner 60%, sampled), for :func:`corridor_from_blocks`'s side
    choice. Only the core is sampled: blocks are inflated well past the
    obstacle, and a padded tail reaching into the next corner must not veto
    a side that is usable where the ego is alongside the obstacle. The
    lookup is ``curvature_at``'s."""
    t = torch.linspace(0.2, 0.8, n_samples, dtype=torch.float32, device=blocks.device)
    s_samp = blocks[:, 0:1] + t[None, :] * (blocks[:, 1:2] - blocks[:, 0:1])
    kap = curvature_at(track, s_samp)                       # (n_obs, n_samples)
    j = torch.argmax(torch.abs(kap), dim=1, keepdim=True)
    return torch.gather(kap, 1, j)[:, 0]


def steerable_curvature(p: VehicleParams, delta_max, headroom: float = 0.97):
    """The largest path curvature the car can hold, with a small headroom:
    a side whose line would saturate the steering is ruled out."""
    tan_d = torch.tan(torch.as_tensor(delta_max, dtype=torch.float32))
    return headroom * tan_d / (p.lf + p.lr)


def corridor_from_blocks(sm, ey_lo, ey_hi, blocks, margin, half, kappa_blk=None, kappa_cap=None):
    """Tighten a per-stage lateral corridor around obstacle blocks.

    ``blocks`` (n_obs, 4) holds rows ``[s0, s1, ey_blk_lo, ey_blk_hi]`` in
    wrapped arc length; ``sm`` is the wrapped scheduled s of any shape,
    ``ey_lo``/``ey_hi`` broadcast against it. At every stage whose ``sm``
    lies in a block the corridor moves to one side of the obstacle, the
    widest usable one; dummy rows (``s0 > s1``) never match. With
    ``kappa_blk`` (:func:`block_curvatures`) and ``kappa_cap``
    (:func:`steerable_curvature`, a scalar or broadcastable against ``sm``)
    the inside of a corner counts only out to the offset where the path
    curvature kappa / (1 - kappa e_y) stays steerable. The moved bound is
    clamped to the track edge; where overlapping blocks chose opposite
    sides and the corridor inverts, it collapses to its midpoint (a
    zero-width corridor, which the soft e_y row handles).

    The JAX package applies the blocks one after another; each step raises
    ``ey_lo`` by a max and lowers ``ey_hi`` by a min, so taking the max and
    the min over all blocks at once gives the same numbers."""
    nb = blocks.shape[0]
    if nb == 0:
        return ey_lo, ey_hi
    col = lambda a: a.reshape((nb,) + (1,) * sm.dim())
    o_s0, o_s1, o_lo, o_hi = (col(blocks[:, j]) for j in range(4))
    inside = (sm >= o_s0) & (sm <= o_s1)                    # (n_obs, *sm.shape)
    up_lim = dn_lim = torch.full_like(o_hi, half)
    if kappa_blk is not None:
        k = col(kappa_blk)
        ak = torch.clamp_min(torch.abs(k), 1e-6)
        # inside-of-corner offset limit: 1 - |k| e_y >= |k| / kappa_cap
        ey_in = torch.clamp((1.0 - ak / kappa_cap) / ak, -half, half)
        up_lim = torch.where(k > 1e-3, torch.clamp_max(ey_in, half), torch.full_like(ey_in, half))
        dn_lim = torch.where(k < -1e-3, torch.clamp_max(ey_in, half), torch.full_like(ey_in, half))
    up_w = up_lim - (o_hi + margin)      # usable width above the obstacle
    dn_w = (o_lo - margin) + dn_lim      # usable width below
    go_up = up_w >= dn_w
    new_lo = torch.where(go_up, torch.clamp_max(o_hi + margin, half), torch.full_like(up_w, -half))
    new_hi = torch.where(go_up, torch.full_like(up_w, half), torch.clamp_min(o_lo - margin, -half))
    neg, pos = torch.full_like(sm, -float("inf")), torch.full_like(sm, float("inf"))
    ey_lo = torch.maximum(ey_lo, torch.where(inside, new_lo, neg).amax(dim=0))
    ey_hi = torch.minimum(ey_hi, torch.where(inside, new_hi, pos).amin(dim=0))
    mid = 0.5 * (ey_lo + ey_hi)
    inv = ey_lo > ey_hi
    return torch.where(inv, mid, ey_lo), torch.where(inv, mid, ey_hi)


def tracker_bounds(p: VehicleParams, cfg: MPCConfig, track: Track, X_sched,
                   obstacles=None, obs_margin: float = 0.0):
    """(B, N+1, N_CON) stage bounds: standard boxes + per-stage
    friction-circle vx caps, the e_y row tightened around ``obstacles``
    ((n_obs, 4) corridor blocks) at every stage whose scheduled s falls in
    a block; stage-0 state rows and terminal input/rate rows disabled."""
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
    pb = broadcast_params(p, X_sched.dim() - 1)
    if cfg.kappa_speed_cap:
        ub[..., 0] = speed_cap_at(pb, track, X_sched[..., _s_index(cfg.model)],
                                  b.vx_min, b.vx_max, cfg.a_lat_frac)
    if obstacles is not None:
        obstacles = torch.as_tensor(obstacles, dtype=torch.float32, device=X_sched.device)
        sm = wrap_s(track, X_sched[..., _s_index(cfg.model)])
        lb[..., 1], ub[..., 1] = corridor_from_blocks(
            sm, lb[..., 1], ub[..., 1], obstacles, obs_margin, b.ey_max,
            kappa_blk=block_curvatures(track, obstacles),
            kappa_cap=steerable_curvature(pb, b.delta_max))
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
    """Assemble the block-structured MPC QP on the augmented state;
    ``obstacles`` ((n_obs, 4) corridor blocks) tighten its e_y row."""
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
    lb, ub = tracker_bounds(p, cfg, track, X_sched, obstacles=obstacles)
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
