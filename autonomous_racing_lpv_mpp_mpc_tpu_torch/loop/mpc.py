"""Receding-horizon LPV-MPC controller step (the JAX package's
``loop/mpc.py``), with the batch written out as the leading dim.

Per step: shift the previous prediction for quasi-LPV scheduling, assemble
the QP, solve warm-started through the production pipeline (equilibrate,
ADMM, polish: ``solver.production``), apply u0 — or the limp-home
controller when the solve is not usable — and keep the prediction for the
next step. When the in-solver infeasibility heuristic fires, OSQP's
Farkas certificate confirms it (``MPCDiag.certified_infeasible``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams
from ..core.device import resolve_device
from ..engine.assembly import N_CON, build_boxqp, initial_schedule, shift_schedule, tracker_bounds
from ..models import model_nx
from ..models.dynamics import NU
from ..ops.stage_math import model_s_ey
from ..planner.reftable import RefTable, refs_from_table
from ..solver.admm import ADMMSolution
from ..solver.production import certify_primal_infeasibility, polish_solution, production_solve
from ..solver.scaling import ruiz_row_equilibrate, unscale_solution
from ..track.track import Track, curvature_at
from ..utils import profiling


class MPCCarry(NamedTuple):
    X_pred: torch.Tensor   # (B, N+1, nx) previous predicted states
    U_pred: torch.Tensor   # (B, N, nu)
    s: torch.Tensor        # (B, N+1, nc) ADMM split warm start
    lam: torch.Tensor      # (B, N+1, nc) ADMM dual warm start
    u_prev: torch.Tensor   # (B, nu) last applied control
    rho: torch.Tensor      # (B,) warm-started ADMM penalty


class MPCDiag(NamedTuple):
    converged: torch.Tensor
    iters: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    # OSQP's Farkas certificate, evaluated only where the in-solver
    # settled-dual heuristic fired; False wherever it did not, where the
    # certificate is off (SolverConfig.certify_infeasibility) and on the
    # kernel routes, which hand no assembled QP to it
    certified_infeasible: torch.Tensor


def constant_refs(cfg: MPCConfig, vx_ref: float, ey_ref: float = 0.0, device=None) -> torch.Tensor:
    """(N+1, nx) reference: track vx_ref, hold e_y at ey_ref, rest 0, on
    ``device`` (``None``: the CUDA card)."""
    nx = model_nx(cfg.model)
    _, ey_i = model_s_ey(cfg.model)
    x_ref = torch.zeros((cfg.N + 1, nx), dtype=torch.float32, device=resolve_device(device))
    x_ref[:, 0] = vx_ref
    x_ref[:, ey_i] = ey_ref
    return x_ref


def mpc_init(p: VehicleParams, cfg: MPCConfig, track: Track, x0: torch.Tensor,
             u0: torch.Tensor | None = None) -> MPCCarry:
    """Initial carry for a batch of states x0 (B, nx)."""
    with profiling.span("mpc.init", profiling.tracing()):
        batch = x0.shape[:-1]
        kw = dict(dtype=torch.float32, device=x0.device)
        if u0 is None:
            u0 = torch.zeros(batch + (NU,), **kw)
        X, U = initial_schedule(p, cfg, track, x0, u0)
        z = torch.zeros(batch + (cfg.N + 1, N_CON), **kw)
        return MPCCarry(X_pred=X, U_pred=U, s=z, lam=z.clone(), u_prev=u0,
                        rho=torch.full(batch, 0.1, **kw))


def _shift_and_warm(x: torch.Tensor, carry: MPCCarry):
    """The schedule for this step and the warm start, both shifted one
    stage: (X_sched (B, N+1, nx) with x in row 0, U_sched, warm = (s, lam,
    Xa, U_sched))."""
    X_shift, U_sched = shift_schedule(carry.X_pred, carry.U_pred)
    X_sched = torch.cat([x.unsqueeze(-2), X_shift[..., 1:, :]], dim=-2)
    s_w = torch.cat([carry.s[..., 1:, :], carry.s[..., -1:, :]], dim=-2)
    lam_w = torch.cat([carry.lam[..., 1:, :], carry.lam[..., -1:, :]], dim=-2)
    uprev_part = torch.cat([carry.u_prev.unsqueeze(-2), U_sched], dim=-2)
    Xa_w = torch.cat([X_sched, uprev_part], dim=-1)
    return X_sched, U_sched, (s_w, lam_w, Xa_w, U_sched)


def mpc_prepare(p: VehicleParams, cfg: MPCConfig, track: Track, x: torch.Tensor,
                x_ref, carry: MPCCarry, obstacles=None):
    """Scheduling + assembly + warm start for one step.

    Returns (qp, warm, U_sched) with warm = (s, lam, Xa, U) shifted one
    stage. ``x_ref`` is (N+1, nx) shared, (B, N+1, nx), or a
    :class:`RefTable` sampled along each lane's scheduled s; ``obstacles``
    ((n_obs, 4) corridor blocks) tighten the e_y row.
    """
    X_sched, U_sched, warm = _shift_and_warm(x, carry)
    if isinstance(x_ref, RefTable):
        x_ref = refs_from_table(cfg, x_ref, X_sched[..., model_s_ey(cfg.model)[0]])
    qp = build_boxqp(p, cfg, track, x, carry.u_prev, X_sched, U_sched, x_ref,
                     obstacles=obstacles)
    return qp, warm, U_sched


def mpc_prepare_light(p: VehicleParams, cfg: MPCConfig, track: Track, x: torch.Tensor, x_ref,
                      carry: MPCCarry, obstacles=None):
    """Scheduling, bounds and warm start WITHOUT the stage matrices: the
    fused solve (``ops.fused_kernel``) builds those itself.

    Returns (X_sched (B, N+1, nx), U_sched, kappas (B, N) by
    ``curvature_at``, x_ref (B, N+1, nx) with vx clamped to the per-stage
    friction cap, lb, ub with the e_y row tightened around ``obstacles``,
    x0a (B, na), warm)."""
    X_sched, U_sched, warm = _shift_and_warm(x, carry)
    s_idx, _ = model_s_ey(cfg.model)
    kappas = curvature_at(track, X_sched[..., :cfg.N, s_idx])
    if isinstance(x_ref, RefTable):
        x_ref = refs_from_table(cfg, x_ref, X_sched[..., s_idx])
    lb, ub = tracker_bounds(p, cfg, track, X_sched, obstacles=obstacles)
    x_ref = x_ref.to(X_sched).expand(X_sched.shape).clone()
    x_ref[..., 0] = torch.minimum(x_ref[..., 0], ub[..., 0])
    x0a = torch.cat([x, carry.u_prev], dim=-1)
    return X_sched, U_sched, kappas, x_ref, lb, ub, x0a, warm


def _certified_infeasible_batch(qp_b, scfg: SolverConfig, sol_b: ADMMSolution) -> torch.Tensor:
    """(B,) certificate behind one any-flag: the certificate (a few more
    reduced iterations and a dual recovery) runs only on a step where some
    QP's heuristic fired. The flag is one host read per step, and only when
    ``certify_infeasibility`` is on and a QP is given."""
    flags = sol_b.primal_infeasible.to(torch.bool)
    if qp_b is None or not scfg.certify_infeasibility or not bool(flags.any()):
        return torch.zeros_like(flags)
    return flags & certify_primal_infeasibility(qp_b, scfg, sol_b)[0]


def _post_solve(p, cfg, scfg, track, x, warm, U_sched, sol: ADMMSolution, qp=None):
    """Limp-home fallback + carry update.

    A solve is usable when it converged or both residuals are below
    ``eps_fallback``; otherwise the car steers geometrically toward the
    centerline and brakes gently, and the shifted schedule is kept. ``qp``
    (the assembled QPs) lets the certificate run.
    """
    nx = model_nx(cfg.model)
    s_idx, ey_idx = model_s_ey(cfg.model)
    kap_now = curvature_at(track, x[..., s_idx])
    delta_ff = torch.atan(kap_now * (p.lf + p.lr)) - 0.5 * x[..., ey_idx] * torch.sign(x[..., 0])
    delta_ff = torch.clamp(delta_ff, -cfg.bounds.delta_max, cfg.bounds.delta_max)
    a_fb = torch.where(x[..., 0] > 2.0 * cfg.bounds.vx_min,
                       torch.full_like(x[..., 0], -0.5), torch.zeros_like(x[..., 0]))
    u_fallback = torch.stack([delta_ff, a_fb], dim=-1)
    X_sched = warm[2][..., :nx]
    usable = sol.converged | ((sol.r_prim < scfg.eps_fallback) & (sol.r_dual < scfg.eps_fallback))
    u = torch.where(usable[..., None], sol.U[..., 0, :], u_fallback)
    X_new = torch.where(usable[..., None, None], sol.X[..., :nx], X_sched)
    U_new = torch.where(usable[..., None, None], sol.U, U_sched)
    new_carry = MPCCarry(X_pred=X_new, U_pred=U_new, s=sol.s, lam=sol.lam,
                         u_prev=u, rho=sol.rho)
    diag = MPCDiag(converged=sol.converged, iters=sol.iters,
                   r_prim=sol.r_prim, r_dual=sol.r_dual,
                   certified_infeasible=_certified_infeasible_batch(qp, scfg, sol))
    return u, new_carry, diag


def mpc_step_batched(p_b: VehicleParams, cfg: MPCConfig, scfg: SolverConfig,
                     track: Track, x_b: torch.Tensor, x_ref, carry_b: MPCCarry, obstacles=None):
    """Batched control step (the JAX package's ``mpc_step`` vmapped over the
    batch). Returns (u (B, nu), new_carry, diag).

    ``scfg.backend``: "plain" solves with ``solver.production.
    production_solve``; "admm" with the solver-only kernel
    ``ops.admm_kernel.admm_kernel_solve`` between Ruiz row equilibration
    and the optional polish; "fused" assembles and solves in one kernel,
    ``ops.fused_kernel.fused_mpc_solve``, after :func:`mpc_prepare_light`
    (its rows are unit-norm by construction), and polishes on a
    re-assembled QP when ``polish`` is set (each kernel's plain version on
    CPU tensors). The whole-step kernel is ``ops.megastep_kernel.megastep``.
    ``obstacles`` ((n_obs, 4) corridor blocks, shared by the batch) tighten
    every route's e_y row through ``tracker_bounds``. Only the "plain" route
    certifies infeasibility; the kernels raise no heuristic flag. While a
    profiler records, the preparation and the post-solve sit in the spans
    ``mpc.prepare`` and ``mpc.post``.
    """
    on = profiling.tracing()
    if scfg.backend == "fused":
        from ..ops.fused_kernel import fused_mpc_solve

        with profiling.span("mpc.prepare", on):
            Xs, Us, kap, xr, lb, ub, x0a, warm_b = mpc_prepare_light(
                p_b, cfg, track, x_b, x_ref, carry_b, obstacles)
        sol_b = fused_mpc_solve(cfg, scfg, p_b, Xs, Us, kap, xr, lb, ub, x0a, warm_b[0], warm_b[1],
                                carry_b.rho)
        if scfg.polish:
            qp_b = mpc_prepare(p_b, cfg, track, x_b, x_ref, carry_b, obstacles)[0]
            sol_b = polish_solution(qp_b, scfg, sol_b)
        with profiling.span("mpc.post", on):
            return _post_solve(p_b, cfg, scfg, track, x_b, warm_b, warm_b[3], sol_b)
    with profiling.span("mpc.prepare", on):
        qp_b, warm_b, U_sched_b = mpc_prepare(p_b, cfg, track, x_b, x_ref, carry_b, obstacles)
    if scfg.backend == "plain":
        sol_b = production_solve(qp_b, scfg, warm=warm_b, rho0=carry_b.rho)
        with profiling.span("mpc.post", on):
            return _post_solve(p_b, cfg, scfg, track, x_b, warm_b, U_sched_b, sol_b, qp=qp_b)
    if scfg.backend != "admm":
        raise ValueError(f"mpc_step_batched backend {scfg.backend!r}; "
                         "the whole-step kernel is ops.megastep_kernel.megastep")
    from ..ops.admm_kernel import admm_kernel_solve

    if scfg.equilibrate:
        qp_s, sc = ruiz_row_equilibrate(qp_b)
        s_w, lam_w, Xa_w, U_w = warm_b
        sol_b = admm_kernel_solve(qp_s, scfg, warm=(s_w * sc.d, lam_w / sc.d, Xa_w, U_w), rho0=carry_b.rho)
        sol_b = unscale_solution(sol_b, sc)
    else:
        sol_b = admm_kernel_solve(qp_b, scfg, warm=warm_b, rho0=carry_b.rho)
    sol_b = polish_solution(qp_b, scfg, sol_b)
    with profiling.span("mpc.post", on):
        return _post_solve(p_b, cfg, scfg, track, x_b, warm_b, U_sched_b, sol_b)


def mpc_step(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
             x: torch.Tensor, x_ref, carry: MPCCarry, obstacles=None):
    """One control step for one vehicle: x (nx,), carry leaves unbatched,
    ``p`` leaves floats or 0-d tensors; ``obstacles`` (n_obs, 4) corridor
    blocks, which the tracker's soft e_y row then clears."""
    one = lambda t: t.unsqueeze(0)
    carry_b = MPCCarry(*(one(t) for t in carry))
    u, new_carry, diag = mpc_step_batched(p, cfg, scfg, track, one(x), x_ref, carry_b, obstacles)
    return (u[0], MPCCarry(*(t[0] for t in new_carry)), MPCDiag(*(t[0] for t in diag)))
