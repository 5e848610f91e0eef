"""MPP: the Model Predictive Planner (the JAX package's ``planner/mpp.py``):
progress-maximizing LPV trajectory optimization over the track centerline.

The planner shares the tracker's engine: ``scheduled_stages`` /
``augment_dynamics`` / ``constraint_rows`` and the production ADMM/Riccati
solve; only the cost (progress reward + trust region) and the per-stage
bounds (curvature speed cap, obstacle-shifted corridor) differ.

SQP: an initial guess from the friction-limited velocity profile, then
``n_sqp`` passes of (relinearize along the iterate -> solve the
long-horizon QP warm-started from the last pass -> adopt the solution).
The default solve is ``SolverConfig(max_iter=400, riccati="assoc")``: the
associative Riccati for the long horizon (H = 256-512), 40 rho chunks of
10 iterations. On the card each chunk is replayed from one CUDA graph per
QP shape (``admm_solve(graphed=True)``), captured at the first plan and
reused by every later plan and replan of that shape, as the JAX package's
module-level ``_sqp_pass`` jit is.

Output: an s-indexed :class:`RefTable` (vx_ref, e_y_ref, delta_ff) sampled
from the plan (the last full lap, or the covered span of a receding plan).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import MPPConfig, SolverConfig, VehicleParams
from ..engine.assembly import (
    N_CON,
    _s_index,
    augment_dynamics,
    block_curvatures,
    constraint_rows,
    corridor_from_blocks,
    scheduled_stages,
    state_indices,
    steerable_curvature,
)
from ..models import model_nx
from ..models.dynamics import NU
from ..solver.admm import ADMMSolution, BoxQP
from ..solver.production import production_solve
from ..solver.riccati import LQRCost, LQRDynamics
from ..track.track import Track, curvature_at, wrap_s
from .reftable import RefTable
from .velocity_profile import curvature_speed_limit, velocity_profile


class MPPDiag(NamedTuple):
    converged: torch.Tensor   # (n_sqp,) per-SQP-pass solver convergence
    iters: torch.Tensor       # (n_sqp,)
    lap_time: torch.Tensor    # [s] estimated from the final trajectory
    progress: torch.Tensor    # total s covered by the plan


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` (increasing xp; constant beyond either end)."""
    xp = xp.contiguous()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2      # jnp.interp's guard: spacing(eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + ((x - xp[i - 1]) / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _floor_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a mod b with the sign of b, from the exact fmod (``jnp.remainder``)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _cell(track: Track, v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """v[cell of s] for an (n_cells,) table v."""
    sm = wrap_s(track, s)
    return v[torch.clamp((sm / track.ds).to(torch.int32), 0, track.n_cells - 1).long()]


def _initial_trajectory(p, pcfg: MPPConfig, track: Track, v_prof, s0=0.0, v0=None):
    """Roll the velocity profile along the centerline -> (X, U) guess. With
    ``v0`` (online replanning) the guess speed is also accel-limited from
    the car's current speed."""
    nx = model_nx(pcfg.model)
    f32 = dict(dtype=torch.float32, device=v_prof.device)
    s0 = torch.as_tensor(s0, **f32)

    def v_at(s):
        v = _cell(track, v_prof, s)
        if v0 is not None:
            reach = torch.sqrt(torch.clamp_min(v0, 0.2) ** 2
                               + 2.0 * pcfg.bounds.a_max * torch.clamp_min(s - s0, 0.0))
            v = torch.minimum(v, reach)
        return v

    s, s_list = s0, []
    for _ in range(pcfg.H + 1):
        s_list.append(s)
        s = s + pcfg.dt * v_at(s)
    s_traj = torch.stack(s_list)
    v_traj = v_at(s_traj)
    kap = curvature_at(track, s_traj)
    X = torch.zeros((pcfg.H + 1, nx), **f32)
    X[:, 0] = v_traj
    X[:, _s_index(pcfg.model)] = s_traj
    if pcfg.model == "dynamic":
        X[:, 2] = kap * v_traj                  # wz ~= kappa * v
    delta_ff = torch.atan(kap * (p.lf + p.lr))
    accel = (v_traj[1:] - v_traj[:-1]) / pcfg.dt
    return X, torch.stack([delta_ff[:-1], accel], dim=1)


def _stage_bounds(p, pcfg: MPPConfig, track: Track, s_sched, obstacles):
    """(H+1, nc) per-stage bounds: curvature speed cap, corridor (shifted
    around obstacle blocks), inputs; stage-0 state rows and terminal
    input/rate rows disabled."""
    b = pcfg.bounds
    H1 = s_sched.shape[0]
    f32 = dict(dtype=torch.float32, device=s_sched.device)
    v_cap = _cell(track, curvature_speed_limit(p, track, b, pcfg.a_lat_frac), s_sched)
    half = float(track.width) / 2 - pcfg.ey_margin
    ey_lo = torch.full((H1,), -half, **f32)
    ey_hi = torch.full((H1,), half, **f32)
    if obstacles is not None:
        blk = torch.as_tensor(obstacles, **f32)
        ey_lo, ey_hi = corridor_from_blocks(
            wrap_s(track, s_sched), ey_lo, ey_hi, blk, pcfg.ey_margin, half,
            kappa_blk=block_curvatures(track, blk),
            kappa_cap=steerable_curvature(p, b.delta_max).to(s_sched.device))
    lo = (None, None, -b.delta_max, b.a_min, -b.ddelta_max, -b.da_max)
    hi = (None, None, b.delta_max, b.a_max, b.ddelta_max, b.da_max)
    lb = torch.empty((H1, N_CON), **f32)
    ub = torch.empty((H1, N_CON), **f32)
    lb[:, 0], ub[:, 0] = b.vx_min, v_cap
    lb[:, 1], ub[:, 1] = ey_lo, ey_hi
    for c in range(2, N_CON):
        lb[:, c], ub[:, c] = lo[c], hi[c]
    inf = float("inf")
    lb[0, :2], ub[0, :2] = -inf, inf
    lb[-1, 2:], ub[-1, 2:] = -inf, inf
    return lb, ub


def _build_planner_qp(p, pcfg: MPPConfig, track: Track, X_bar, U_bar, u_prev, obstacles) -> BoxQP:
    H = pcfg.H
    nx = model_nx(pcfg.model)
    na = nx + NU
    f32 = dict(dtype=torch.float32, device=X_bar.device)
    s_idx = _s_index(pcfg.model)

    Ad, Bd, cd = scheduled_stages(p, pcfg, track, X_bar, U_bar)
    Aa, Ba, ca = augment_dynamics(Ad, Bd, cd)

    Qt = torch.tensor(pcfg.q_trust[:nx], **f32)
    dR = torch.diag(torch.tensor(pcfg.dr, **f32))
    Rd = torch.diag(torch.tensor(pcfg.r, **f32))
    Q1 = torch.zeros((na, na), **f32)
    Q1[:nx, :nx] = torch.diag(Qt)
    Q_stage = Q1.clone()
    Q_stage[nx:, nx:] = dR
    Q = Q_stage.expand(H + 1, na, na).clone()
    Q[H] = Q1
    R = (Rd + dR).expand(H, NU, NU).clone()
    M_stage = torch.zeros((na, NU), **f32)
    M_stage[nx:, :] = -dR
    M = M_stage.expand(H, na, NU).clone()

    # linear cost: the trust region pulls to the iterate; progress reward on s
    q = torch.zeros((H + 1, na), **f32)
    q[:, :nx] = -(X_bar * Qt)
    q[:, s_idx] += -pcfg.w_progress / (H + 1)
    q[H, s_idx] += -pcfg.w_progress
    r = torch.zeros((H, NU), **f32)

    Dx, Du = constraint_rows(pcfg.model, **f32)
    lb, ub = _stage_bounds(p, pcfg, track, X_bar[:, s_idx], obstacles)
    soft = torch.full((N_CON,), float("inf"), **f32)
    soft[1] = 2000.0
    return BoxQP(dyn=LQRDynamics(Aa, Ba, ca), cost=LQRCost(Q, q, R, r, M), Dx=Dx, Du=Du,
                 lb=lb, ub=ub, x0=torch.cat([X_bar[0], u_prev]), soft=soft)


def _build_table(p, pcfg: MPPConfig, track: Track, s_traj, vx_tr, ey_tr, delta_tr_u, v_prof) -> RefTable:
    """Sample the optimized trajectory onto a uniform s grid.

    Full-lap plans (progress >= track length) use the last lap. Partial
    plans (online replanning) fill the covered span, with the planned line
    tapered back to the centerline over its last metre (a hard seam would be
    a heading-reference spike); uncovered cells fall back to the velocity
    profile on the centerline with geometric feed-forward steering."""
    f32 = dict(dtype=torch.float32, device=s_traj.device)
    length = float(track.length)
    n_ref = max(8, int(round(length / pcfg.ds_ref)))
    s_grid = torch.arange(n_ref, **f32) * (length / n_ref)
    delta_tr = torch.cat([delta_tr_u, delta_tr_u[-1:]])

    s_end = s_traj[-1]
    progress = s_end - s_traj[0]
    L32 = torch.tensor(length, **f32)
    span = torch.minimum(progress, L32)
    base = s_end - span
    qs = base + _floor_mod(s_grid - base, L32)
    covered = qs <= s_end
    vx_tab = _interp(qs, s_traj, vx_tr)
    ey_tab = _interp(qs, s_traj, ey_tr)
    dl_tab = _interp(qs, s_traj, delta_tr)

    taper = torch.clamp_max(0.5 * span, 1.0)
    w_tail = torch.clamp((s_end - qs) / torch.clamp_min(taper, 1e-3), 0.0, 1.0)
    w_tail = torch.where(progress < L32, w_tail, torch.ones_like(w_tail))
    ey_tab = ey_tab * w_tail

    idx = torch.clamp((s_grid / track.ds).to(torch.int32), 0, track.n_cells - 1).long()
    vx_fb = v_prof[idx]
    dl_fb = torch.atan(track.kappa[idx] * (p.lf + p.lr))
    return RefTable(
        ds=torch.tensor(length / n_ref, **f32), length=L32,
        vx=torch.where(covered, vx_tab, vx_fb),
        ey=torch.where(covered, ey_tab, torch.zeros_like(ey_tab)),
        delta=torch.where(covered, dl_tab, dl_fb),
    )


def _sqp_pass(p, pcfg, track, scfg, X_bar, U_bar, obstacles, warm, graphed) -> ADMMSolution:
    """One SQP pass: relinearize along the iterate, solve the planner QP."""
    qp = _build_planner_qp(p, pcfg, track, X_bar, U_bar, U_bar[0], obstacles)
    return production_solve(qp, scfg, warm=warm, graphed=graphed)


def plan_mpp(
    p: VehicleParams,
    pcfg: MPPConfig,
    track: Track,
    scfg: Optional[SolverConfig] = None,
    obstacles=None,                  # (n_obs, 4): s0, s1, ey_lo, ey_hi
    s0: float = 0.0,
    x0_state: Optional[torch.Tensor] = None,    # current car state (online mode)
    graphed: bool = True,
):
    """Run the MPP on the track's device. Returns (RefTable, MPPDiag).

    Offline (default): plans >= 1 lap from the velocity profile and samples
    the last lap. Online (``x0_state`` given): plans a receding horizon from
    the car's state; the table covers the planned span and falls back to
    the profile elsewhere. ``obstacles`` (padded corridor blocks) shift the
    corridor. On the card the solves replay CUDA graphs (``graphed=False``:
    every launch eager, for comparison)."""
    # long-horizon ADMM needs a bigger budget than the tracker (~400 its at
    # H=512 cold; warm-started SQP passes finish much earlier)
    scfg = scfg or SolverConfig(max_iter=400, riccati="assoc")
    nx = model_nx(pcfg.model)
    s_idx = _s_index(pcfg.model)
    _, ey_i = state_indices(pcfg.model)

    v_prof = velocity_profile(p, track, pcfg.bounds, pcfg.a_lat_frac)
    v0 = None
    if x0_state is not None:
        x0_state = torch.as_tensor(x0_state, dtype=torch.float32, device=v_prof.device)
        s0, v0 = x0_state[s_idx], x0_state[0]
    X_bar, U_bar = _initial_trajectory(p, pcfg, track, v_prof, s0, v0)
    if x0_state is not None:
        X_bar[0] = x0_state

    convs, iters = [], []
    warm = None
    for _ in range(pcfg.n_sqp):
        sol = _sqp_pass(p, pcfg, track, scfg, X_bar, U_bar, obstacles, warm, graphed)
        X_bar, U_bar = sol.X[:, :nx], sol.U
        warm = (sol.s, sol.lam, sol.X, sol.U)       # warm-started SQP
        convs.append(sol.converged)
        iters.append(sol.iters)

    s_traj = X_bar[:, s_idx]
    table = _build_table(p, pcfg, track, s_traj, X_bar[:, 0], X_bar[:, ey_i], U_bar[:, 0], v_prof)
    steps = torch.arange(pcfg.H + 1, dtype=torch.float32, device=s_traj.device)
    t_idx = _interp((s_traj[0] + float(track.length)).reshape(1), s_traj, steps)[0]
    diag = MPPDiag(converged=torch.stack(convs), iters=torch.stack(iters),
                   lap_time=t_idx * pcfg.dt, progress=s_traj[-1] - s_traj[0])
    return table, diag
