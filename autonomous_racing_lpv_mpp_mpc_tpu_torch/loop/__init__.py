from .closed_loop import ClosedLoopLog, closed_loop, plant_step
from .mpc import (
    MPCCarry,
    MPCDiag,
    constant_refs,
    mpc_init,
    mpc_prepare,
    mpc_step,
    mpc_step_batched,
)

__all__ = [
    "ClosedLoopLog",
    "MPCCarry",
    "MPCDiag",
    "closed_loop",
    "constant_refs",
    "mpc_init",
    "mpc_prepare",
    "mpc_step",
    "mpc_step_batched",
    "plant_step",
]
