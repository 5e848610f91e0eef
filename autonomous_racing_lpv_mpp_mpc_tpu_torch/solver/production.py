"""The production QP solve: (equilibrate) -> ADMM -> (polish), the JAX
package's ``solver/production.py``; ``loop.mpc`` and the planner solve
through it.

- Equilibrate (``SolverConfig.equilibrate``, on by default like OSQP's
  ``scaling``): Ruiz row equilibration of the box rows
  (``solver.scaling``). The tracker's and planner's own rows are +-1
  selectors, for which it is exactly the identity.
- Polish (``SolverConfig.polish``, off by default like OSQP): active-set
  refinement on the original-row problem (``solver.polish``); it replaces
  (X, U, lam) only when it lowers the KKT residual, and ``s`` keeps the
  ADMM split value (it only seeds the next warm start).
- :func:`certify_primal_infeasibility`: OSQP's Farkas certificate on the
  stacked problem, for when the in-solver heuristic fires.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.config import SolverConfig
from .admm import ADMMSolution, ADMMState, BoxQP, _folded_cost, _iterate, admm_solve, admm_solve_single
from .polish import _recover_eq_duals, _solution_z, polish, stack_boxqp
from .riccati import riccati_factor
from .scaling import admm_solve_equilibrated


def production_solve(qp: BoxQP, cfg: SolverConfig, warm: Optional[Tuple[torch.Tensor, ...]] = None,
                     rho0: Optional[torch.Tensor] = None, single: bool = False,
                     graphed: bool = False) -> ADMMSolution:
    """Solve a (batched) BoxQP through the full pipeline: ``admm_solve``
    (``single=False``) or ``admm_solve_single`` (``single=True``) with the
    configured equilibration and polish. Warm starts are in original row
    units; ``graphed`` as in ``admm_solve``."""
    if cfg.equilibrate:
        sol = admm_solve_equilibrated(qp, cfg, warm=warm, rho0=rho0, single=single, graphed=graphed)
    elif single:
        sol = admm_solve_single(qp, cfg, warm)
    else:
        sol = admm_solve(qp, cfg, warm=warm, rho0=rho0, graphed=graphed)
    return polish_solution(qp, cfg, sol)


def polish_solution(qp: BoxQP, cfg: SolverConfig, sol: ADMMSolution) -> ADMMSolution:
    """The configured polish of an original-row solution (also for solutions
    from a kernel: assemble the QP and pass the kernel's solution here)."""
    if not cfg.polish:
        return sol
    pr = polish(qp, sol)
    return sol._replace(X=pr.X, U=pr.U, lam=pr.lam,
                        r_prim=torch.minimum(sol.r_prim, pr.r_prim),
                        r_dual=torch.minimum(sol.r_dual, pr.r_dual))


def certify_primal_infeasibility(qp: BoxQP, cfg: SolverConfig, sol: ADMMSolution,
                                 extra_iters: int = 10, eps_pinf: float = 1e-4):
    """OSQP's exact primal-infeasibility certificate (Farkas conditions).

    The in-solver flag is a settled-dual heuristic: the dynamics rows are
    eliminated, so their dual deltas are invisible to the iteration. Here a
    few more reduced iterations run at the final rho, the full dual vector
    (equality duals by ``polish._recover_eq_duals``) is recovered at the
    last two iterates, and OSQP's conditions are tested on the stacked
    problem with dy their difference:

        ||A' dy||_inf <= eps ||dy||_inf
        u'[dy]_+ + l'[dy]_- <= -eps ||dy||_inf

    (a row with an infinite bound may not carry a matching-sign component).
    Returns (certified (batch) bool, dy (batch, m))."""
    st = stack_boxqp(qp)
    rho = sol.rho
    fac = riccati_factor(qp.dyn, _folded_cost(qp, rho, cfg.sigma), cfg.riccati)

    def full_dual(state: ADMMState):
        y_box = state.lam.reshape(state.lam.shape[:-2] + (-1,))
        return torch.cat([_recover_eq_duals(st, _solution_z(state), y_box), y_box], dim=-1)

    big = torch.full_like(sol.r_prim, float("inf"))
    state = ADMMState(sol.X, sol.U, sol.s, sol.lam, big, big, torch.zeros_like(big),
                      torch.zeros_like(big), torch.zeros_like(sol.converged))
    y = y_prev = full_dual(state)
    for _ in range(extra_iters):
        state = _iterate(qp, fac, cfg, rho, state)
        y_prev, y = y, full_dual(state)
    dy = y - y_prev        # the last one-step delta

    norm = dy.abs().amax(dim=-1)
    dyp, dym = torch.clamp_min(dy, 0.0), torch.clamp_max(dy, 0.0)
    fin_u, fin_l = torch.isfinite(st.u), torch.isfinite(st.l)
    lim = eps_pinf * norm[..., None]
    inf_ok = ((fin_u | (dyp.abs() <= lim)) & (fin_l | (dym.abs() <= lim))).all(dim=-1)
    zero = torch.zeros_like(dy)
    sup = torch.where(fin_u, st.u * dyp, zero).sum(dim=-1) + torch.where(fin_l, st.l * dym, zero).sum(dim=-1)
    at_dy = (st.A.transpose(-1, -2) @ dy.unsqueeze(-1)).squeeze(-1).abs().amax(dim=-1)
    certified = (norm > 1e-14) & inf_ok & (at_dy <= eps_pinf * norm) & (sup <= -eps_pinf * norm)
    return certified, dy
