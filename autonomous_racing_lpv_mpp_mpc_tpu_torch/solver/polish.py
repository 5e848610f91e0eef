"""Solution polishing: OSQP's active-set refinement (the JAX package's
``solver/polish.py``).

After ADMM stops at eps accuracy, guess the active set from the duals and
the split variable, solve the equality-constrained QP restricted to those
rows through a delta-regularized KKT system with iterative refinement, and
keep the result only if it lowers the KKT residual and its multipliers
keep the signs the guess implies.

The block QP is stacked to a dense one (z = [x_1..x_N, u_0..u_{N-1}], the
layout of ``oracle/stack.py``); leading batch dims are kept throughout.
Inactive box rows are zeroed in the KKT (their -delta diagonal pins their
dual to 0), so the shapes never depend on the active set. Rows with a
finite softness (the soft corridor) are never taken as active.

Size: the KKT is (nz + m) square with nz = N(na + nu) and
m = N na + (N+1) nc, about 490 x 490 for the tracker at N=20 (1 MB per QP):
at B=4096 that is gigabytes, so polish stays off on the batched card paths,
as its default (``SolverConfig.polish=False``) has it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .admm import ADMMSolution, BoxQP


class StackedQP(NamedTuple):
    P: torch.Tensor   # (..., nz, nz)
    q: torch.Tensor   # (..., nz)
    A: torch.Tensor   # (..., m, nz): dynamics rows, then box rows
    l: torch.Tensor   # (..., m)
    u: torch.Tensor   # (..., m)
    n_eq: int         # leading rows of A that are equalities (dynamics)


def _mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def stack_boxqp(qp: BoxQP) -> StackedQP:
    """Dense stacked form of a BoxQP (the JAX ``stack_boxqp_jax``, the
    layout of the numpy oracle's ``stack_boxqp``): min 1/2 z'Pz + q'z s.t.
    l <= Az <= u, with the constant x0 cost terms dropped."""
    A_, B_, c_ = qp.dyn.A, qp.dyn.B, qp.dyn.c
    N, nx, nu = B_.shape[-3:]
    nc = qp.Dx.shape[0]
    nz = N * nx + N * nu
    batch = qp.x0.shape[:-1]
    kw = dict(dtype=A_.dtype, device=A_.device)
    xi = lambda k: slice((k - 1) * nx, k * nx)
    ui = lambda k: slice(N * nx + k * nu, N * nx + (k + 1) * nu)
    x0 = qp.x0

    P = torch.zeros(batch + (nz, nz), **kw)
    qv = torch.zeros(batch + (nz,), **kw)
    for k in range(1, N + 1):
        P[..., xi(k), xi(k)] = qp.cost.Q[..., k, :, :]
        qv[..., xi(k)] = qp.cost.q[..., k, :]
    for k in range(N):
        P[..., ui(k), ui(k)] = qp.cost.R[..., k, :, :]
        qv[..., ui(k)] = qp.cost.r[..., k, :]
    for k in range(1, N):
        P[..., xi(k), ui(k)] = qp.cost.M[..., k, :, :]
        P[..., ui(k), xi(k)] = qp.cost.M[..., k, :, :].transpose(-1, -2)
    qv[..., ui(0)] += _mv(qp.cost.M[..., 0, :, :].transpose(-1, -2), x0)

    Aeq = torch.zeros(batch + (N * nx, nz), **kw)
    beq = torch.zeros(batch + (N * nx,), **kw)
    I = torch.eye(nx, **kw)
    for k in range(N):
        rows = slice(k * nx, (k + 1) * nx)
        Aeq[..., rows, xi(k + 1)] = I
        Aeq[..., rows, ui(k)] = -B_[..., k, :, :]
        beq[..., rows] = c_[..., k, :]
        if k == 0:
            beq[..., rows] += _mv(A_[..., 0, :, :], x0)
        else:
            Aeq[..., rows, xi(k)] = -A_[..., k, :, :]

    Ain = torch.zeros(batch + ((N + 1) * nc, nz), **kw)
    lin = torch.zeros(batch + ((N + 1) * nc,), **kw)
    uin = torch.zeros(batch + ((N + 1) * nc,), **kw)
    Dx_x0 = _mv(qp.Dx, x0)
    for k in range(N + 1):
        rows = slice(k * nc, (k + 1) * nc)
        if k == 0:
            Ain[..., rows, ui(0)] = qp.Du
            lin[..., rows] = qp.lb[..., 0, :] - Dx_x0
            uin[..., rows] = qp.ub[..., 0, :] - Dx_x0
        elif k < N:
            Ain[..., rows, xi(k)] = qp.Dx
            Ain[..., rows, ui(k)] = qp.Du
            lin[..., rows] = qp.lb[..., k, :]
            uin[..., rows] = qp.ub[..., k, :]
        else:
            Ain[..., rows, xi(N)] = qp.Dx
            lin[..., rows] = qp.lb[..., N, :]
            uin[..., rows] = qp.ub[..., N, :]

    return StackedQP(P=P, q=qv, A=torch.cat([Aeq, Ain], dim=-2), l=torch.cat([beq, lin], dim=-1),
                     u=torch.cat([beq, uin], dim=-1), n_eq=N * nx)


def kkt_residuals(st: StackedQP, z, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r_prim, r_dual) inf-norm KKT residuals of the stacked QP."""
    Az = _mv(st.A, z)
    r_prim = (torch.clamp_min(Az - st.u, 0.0) + torch.clamp_min(st.l - Az, 0.0)).amax(dim=-1)
    r_dual = (_mv(st.P, z) + st.q + _mv(st.A.transpose(-1, -2), y)).abs().amax(dim=-1)
    return r_prim, r_dual


class PolishResult(NamedTuple):
    X: torch.Tensor          # (..., N+1, nx), X[0] = x0
    U: torch.Tensor          # (..., N, nu)
    lam: torch.Tensor        # (..., N+1, nc) polished box duals (original rows)
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    improved: torch.Tensor   # bool: the polished iterate beat the ADMM one


def _solution_z(sol: ADMMSolution) -> torch.Tensor:
    """z = [x_1..x_N, u_0..u_{N-1}] of a solution, batch-first."""
    batch = sol.U.shape[:-2]
    return torch.cat([sol.X[..., 1:, :].reshape(batch + (-1,)), sol.U.reshape(batch + (-1,))], dim=-1)


def _recover_eq_duals(st: StackedQP, z, y_box):
    """Least-squares equality duals: argmin_nu ||Pz + q + Aeq' nu + Ain' y||,
    from (Aeq Aeq' + 1e-8 I) nu = Aeq rhs (Aeq has full row rank)."""
    n_eq = st.n_eq
    Aeq = st.A[..., :n_eq, :]
    rhs = -(_mv(st.P, z) + st.q + _mv(st.A[..., n_eq:, :].transpose(-1, -2), y_box))
    G = Aeq @ Aeq.transpose(-1, -2) + 1e-8 * torch.eye(n_eq, dtype=z.dtype, device=z.device)
    return torch.linalg.solve_ex(G, _mv(Aeq, rhs))[0]


def polish(qp: BoxQP, sol: ADMMSolution, delta: float = 1e-6, refine_iters: int = 3) -> PolishResult:
    """Active-set polish of an ADMM solution (OSQP semantics): the polished
    primal/dual iterate where it lowers the max KKT residual and keeps the
    multiplier signs, the original one otherwise. The KKT solve is one LU
    (``torch.linalg.lu_factor_ex`` / ``lu_solve``) with ``refine_iters``
    rounds of iterative refinement against the unregularized system."""
    st = stack_boxqp(qp)
    N, nx, nu = qp.dyn.B.shape[-3:]
    nc = qp.Dx.shape[0]
    batch = qp.x0.shape[:-1]
    nz = st.P.shape[-1]
    m = st.A.shape[-2]
    kw = dict(dtype=st.P.dtype, device=st.P.device)
    n_eq = st.n_eq

    z0 = _solution_z(sol)
    y_box0 = sol.lam.reshape(batch + (-1,))
    nu0 = _recover_eq_duals(st, z0, y_box0)
    rp0, rd0 = kkt_residuals(st, z0, torch.cat([nu0, y_box0], dim=-1))

    # active set: the dual's sign AND the split variable sitting on the
    # bound (the projection puts it there exactly); wrong guesses are caught
    # by the acceptance test below
    hard_full = torch.isinf(qp.soft).repeat(N + 1)
    lam_flat, s_flat = y_box0, sol.s.reshape(batch + (-1,))
    lbf, ubf = qp.lb.reshape(batch + (-1,)), qp.ub.reshape(batch + (-1,))
    fin_l, fin_u = torch.isfinite(lbf), torch.isfinite(ubf)
    tol_lo = 1e-3 * (1.0 + torch.where(fin_l, lbf, torch.zeros_like(lbf)).abs())
    tol_up = 1e-3 * (1.0 + torch.where(fin_u, ubf, torch.zeros_like(ubf)).abs())
    act_lo = hard_full & (lam_flat < 0) & (s_flat - lbf <= tol_lo) & fin_l
    act_up = hard_full & (lam_flat > 0) & (ubf - s_flat <= tol_up) & fin_u
    active = act_lo | act_up
    b_box = torch.where(act_lo, st.l[..., n_eq:], st.u[..., n_eq:])
    b_box = torch.where(active, b_box, torch.zeros_like(b_box))

    eq_mask = torch.cat([torch.ones(batch + (n_eq,), dtype=torch.bool, device=kw["device"]), active], dim=-1)
    A_act = torch.where(eq_mask[..., :, None], st.A, torch.zeros_like(st.A))
    b_act = torch.cat([st.l[..., :n_eq], b_box], dim=-1)
    A_actT = A_act.transpose(-1, -2)

    K = torch.cat([
        torch.cat([st.P + delta * torch.eye(nz, **kw), A_actT], dim=-1),
        torch.cat([A_act, (-delta * torch.eye(m, **kw)).expand(batch + (m, m))], dim=-1),
    ], dim=-2)
    rhs = torch.cat([-st.q, b_act], dim=-1)
    LU, piv, _ = torch.linalg.lu_factor_ex(K)
    lu_solve = lambda b: torch.linalg.lu_solve(LU, piv, b.unsqueeze(-1)).squeeze(-1)
    v = lu_solve(rhs)
    for _ in range(refine_iters):
        z, y = v[..., :nz], v[..., nz:]
        res = rhs - torch.cat([_mv(st.P, z) + _mv(A_actT, y), _mv(A_act, z)], dim=-1)
        v = v + lu_solve(res)
    z1, y1 = v[..., :nz], v[..., nz:]
    y1 = torch.cat([y1[..., :n_eq], torch.where(active, y1[..., n_eq:], torch.zeros_like(y1[..., n_eq:]))], dim=-1)
    rp1, rd1 = kkt_residuals(st, z1, y1)

    # accept: residuals improved AND the multipliers keep the signs their
    # activity guess implies
    y1_box = y1[..., n_eq:]
    y_tol = 1e-5 * (1.0 + y1_box.abs().amax(dim=-1, keepdim=True))
    signs_ok = ((~act_lo | (y1_box <= y_tol)) & (~act_up | (y1_box >= -y_tol))).all(dim=-1)
    better = signs_ok & (torch.maximum(rp1, rd1) < torch.maximum(rp0, rd0))
    z = torch.where(better[..., None], z1, z0)
    y_box = torch.where(better[..., None], y1_box, y_box0)
    X = torch.cat([qp.x0.unsqueeze(-2), z[..., : N * nx].reshape(batch + (N, nx))], dim=-2)
    U = z[..., N * nx:].reshape(batch + (N, nu))
    return PolishResult(X=X, U=U, lam=y_box.reshape(batch + (N + 1, nc)),
                        r_prim=torch.where(better, rp1, rp0), r_dual=torch.where(better, rd1, rd0),
                        improved=better)
