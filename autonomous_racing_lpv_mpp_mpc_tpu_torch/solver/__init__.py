from .admm import (
    ADMMSolution,
    ADMMState,
    BoxQP,
    admm_solve,
    admm_solve_single,
    hard_rows,
    qp_objective,
)
from .polish import PolishResult, StackedQP, kkt_residuals, polish, stack_boxqp
from .production import certify_primal_infeasibility, polish_solution, production_solve
from .riccati import (
    LQRCost,
    LQRDynamics,
    RiccatiFactors,
    lqr_linear_solve,
    lqr_solve,
    riccati_factor,
    riccati_factor_assoc,
    riccati_factor_scan,
)
from .scaling import (
    RowScaling,
    admm_solve_equilibrated,
    ruiz_row_equilibrate,
    unscale_duals,
    unscale_solution,
)

# the JAX package's name for the stacker
stack_boxqp_jax = stack_boxqp

__all__ = [
    "ADMMSolution",
    "ADMMState",
    "BoxQP",
    "LQRCost",
    "LQRDynamics",
    "PolishResult",
    "RiccatiFactors",
    "RowScaling",
    "StackedQP",
    "admm_solve",
    "admm_solve_equilibrated",
    "admm_solve_single",
    "certify_primal_infeasibility",
    "hard_rows",
    "kkt_residuals",
    "lqr_linear_solve",
    "lqr_solve",
    "polish",
    "polish_solution",
    "production_solve",
    "qp_objective",
    "riccati_factor",
    "riccati_factor_assoc",
    "riccati_factor_scan",
    "ruiz_row_equilibrate",
    "stack_boxqp",
    "stack_boxqp_jax",
    "unscale_duals",
    "unscale_solution",
]
