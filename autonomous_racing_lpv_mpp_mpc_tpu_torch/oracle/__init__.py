"""The f64 OSQP-semantics oracle on the host (numpy/scipy): the ground
truth that the port's solvers and kernels are held against.
``oracle.native`` holds the C++ core's binding, a second implementation
for cross-checks."""

from .osqp_ref import OsqpRefResult, OsqpRefSettings, osqp_ref_solve
from .stack import stack_boxqp, unstack_solution

__all__ = [
    "OsqpRefSettings",
    "OsqpRefResult",
    "osqp_ref_solve",
    "stack_boxqp",
    "unstack_solution",
]
