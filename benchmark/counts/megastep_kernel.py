"""The megastep kernel: the whole closed-loop step per lane (the solve and
``n_sub`` plant sub-steps) in one launch."""

from __future__ import annotations

from benchmark.counts.structure import core_ops, plant_ops, structure


def bytes_per_lane(nx: int, N: int) -> int:
    """The carry in and out (x, X_pred, U_pred, s, lam, u_prev), rho, the
    reference, the vehicle rows and the stats rows written."""
    carry = nx + (N + 1) * nx + 2 * N + 2 * 6 * (N + 1) + 2
    return 4 * (2 * carry + 1 + (N + 1) * nx + 10 + 8)


def per_launch(setup, lanes: int, iters: float, n_cells: int):
    """(operations, bytes) of one launch; the shared curvature table is
    read once per launch."""
    S = structure(setup)
    nx = S.A.shape[0]
    ops = core_ops(S, setup.tire, setup.N, iters) + plant_ops(S, setup.sim_tire, setup.n_sub)
    return lanes * ops, lanes * bytes_per_lane(nx, setup.N) + 4 * n_cells
