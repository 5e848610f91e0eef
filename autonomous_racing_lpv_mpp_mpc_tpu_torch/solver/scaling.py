"""Ruiz row equilibration of the box rows (the JAX package's
``solver/scaling.py``).

The dynamics are eliminated exactly by the Riccati sweep, so only the box
rows [Dx Du] see the ADMM splitting; each row i is scaled by d_i so that
its inf-norm is 1. With one scalar rho that is OSQP's per-row
rho_i = rho / d_i^2 on the original rows. No column scaling: it would
rescale A/B/Q/R and the Riccati recursion.

Scaling map (row i, scale d_i):
    Dx'_i = d_i Dx_i,  Du'_i = d_i Du_i,  lb' = d lb,  ub' = d ub
    soft'_i = soft_i / d_i^2,  lam_i = d_i lam'_i

The rows and d are shared by the batch ((nc,)); bounds broadcast over it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import SolverConfig
from .admm import ADMMSolution, BoxQP, admm_solve, admm_solve_single


class RowScaling(NamedTuple):
    d: torch.Tensor   # (nc,) per-row scale applied to [Dx Du], lb, ub


def ruiz_row_equilibrate(qp: BoxQP, iters: int = 1, min_scale: float = 1e-4,
                         max_scale: float = 1e4) -> Tuple[BoxQP, RowScaling]:
    """Scale the constraint rows to unit inf-norm: row-only Ruiz reaches it
    in one step (d_i = 1/||row_i||_inf, clipped to [min_scale, max_scale]);
    ``iters`` is kept for the JAX signature. Returns the scaled QP and the
    scaling that maps duals back (:func:`unscale_duals`). X and U are
    unchanged by row scaling; ``s`` and the bounds live in the scaled
    space."""
    del iters
    row_norm = torch.maximum(qp.Dx.abs().amax(dim=1), qp.Du.abs().amax(dim=1))
    d = torch.clamp(1.0 / torch.clamp_min(row_norm, 1e-12), min_scale, max_scale)
    scaled = qp._replace(
        Dx=d[:, None] * qp.Dx,
        Du=d[:, None] * qp.Du,
        lb=qp.lb * d,
        ub=qp.ub * d,
        soft=torch.where(torch.isinf(qp.soft), qp.soft, qp.soft / (d * d)),
    )
    return scaled, RowScaling(d=d)


def unscale_duals(lam_scaled: torch.Tensor, scaling: RowScaling) -> torch.Tensor:
    """Duals of the scaled rows mapped back to the original rows."""
    return lam_scaled * scaling.d


def unscale_solution(sol: ADMMSolution, scaling: RowScaling) -> ADMMSolution:
    """The solution in original-row units (X, U need nothing)."""
    return sol._replace(lam=unscale_duals(sol.lam, scaling), s=sol.s / scaling.d)


def admm_solve_equilibrated(qp: BoxQP, cfg: SolverConfig, warm=None, rho0=None,
                            single: bool = False, iters: int = 3,
                            graphed: bool = False) -> ADMMSolution:
    """Equilibrate the rows, solve, and unscale the duals and split variable.

    Warm starts (s, lam, X, U) are in ORIGINAL row units and mapped into the
    scaled space here. The returned residuals are the scaled problem's
    (OSQP likewise terminates on scaled residuals). ``graphed`` as in
    :func:`admm_solve` (the early-exit solve has no graph)."""
    scaled, sc = ruiz_row_equilibrate(qp, iters=iters)
    if warm is not None:
        s, lam, X, U = warm
        warm = (s * sc.d, lam / sc.d, X, U)
    if single:
        sol = admm_solve_single(scaled, cfg, warm)
    else:
        sol = admm_solve(scaled, cfg, warm, rho0=rho0, graphed=graphed)
    return unscale_solution(sol, sc)
