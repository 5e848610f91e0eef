"""The fused kernel: stage build, folded cost, Riccati factor and ADMM per
lane in one launch (no plant, no schedule: those stay around it)."""

from __future__ import annotations

from benchmark.counts.structure import NC, fold_ops, factor_ops, iteration_ops, stage_build_ops, structure


def bytes_per_lane(nx: int, N: int) -> int:
    """Inputs xs, us, kap, xref, prm, lb, ub, x0a, s0, lam0, rho read once;
    X, U, s, lam, stats written once."""
    na = nx + 2
    ins = N * nx + 2 * N + N + (N + 1) * nx + 10 + 4 * NC * (N + 1) + na + 1
    outs = (N + 1) * na + 2 * N + 2 * NC * (N + 1) + 8
    return 4 * (ins + outs)


def per_launch(setup, lanes: int, iters: float, n_cells: int):
    """(operations, bytes) of one launch: N stage builds, the linear cost
    and warm-start clip, the folded cost, N factor stages, ``iters``
    iterations, r_dual."""
    del n_cells
    S = structure(setup)
    nx, N = S.A.shape[0], setup.N
    ops = (N * stage_build_ops(S, setup.tire) + (N + 1) * (nx + 2 * NC) + fold_ops(S)
           + N * factor_ops(S.Aa, S.Ba) + iters * iteration_ops(S, N) + 1)
    return lanes * ops, lanes * bytes_per_lane(nx, N)
