from .admm import ADMMSolution, ADMMState, BoxQP, admm_solve
from .riccati import (
    LQRCost,
    LQRDynamics,
    RiccatiFactors,
    lqr_linear_solve,
    riccati_factor,
    riccati_factor_scan,
)

__all__ = [
    "ADMMSolution",
    "ADMMState",
    "BoxQP",
    "LQRCost",
    "LQRDynamics",
    "RiccatiFactors",
    "admm_solve",
    "lqr_linear_solve",
    "riccati_factor",
    "riccati_factor_scan",
]
