"""The racestep kernel: the composed step per lane in one launch: the
measurement, the EKF and the friction RLS at mu-hat, the reference rows
from the table, the tracker's solve at mu-hat with Pacejka secant
stiffnesses, and the world-frame plant. Statement counts follow
``reference/race.py``'s sections in order, by the rules of
``counts/structure.py``."""

from __future__ import annotations

from benchmark.counts.structure import NC, NU, SCALAR_OPS, core_ops, structure, tyre_ops

NX = 6

RACE_OPS = {
    # the hint cell: wrap 4, multiply, truncate, clamp 2
    "hint": 8,
    # per window cell: the cell id's wrap 1, dx, dy 2, dx^2 + dy^2 3, the
    # compare 1
    "candidate": 7,
    # the projection: cos/sin 2, ddx/ddy 2, along 3, e_y 3, s 2 + wrap 4,
    # kap_at 7, dpsi 3, e_psi (sin, cos, atan2) 3, the lap unwrap 4, s 2;
    # the noise 6
    "project": sum((2, 2, 3, 3, 6, SCALAR_OPS["kap_at"], 3, 3, 4, 2, NX)),
    # the Frenet model's Euler step 2 NX and the perturbations NX; the
    # forward differences 2 NX^2, I + h J 2 NX^2; per sub-step
    "ekf_sub": 2 * NX + NX + 4 * NX * NX + SCALAR_OPS["kap_at"],
    # the RLS: the midpoint 6, y1 5, y2 3, L 1, cos and its floor 2, vx
    # floor 1; per axle: y_m 4, the slip 4, fz 4, Fy and dFy/dmu 18, the
    # gate 3, the gain 5, mu-hat 5, P 4, the selects 2
    "rls": 6 + 5 + 3 + 1 + 2 + 1 + 2 * (4 + 4 + 4 + 18 + 3 + 5 + 5 + 4 + 2),
    # per reference row: wrap 4, multiply, truncate and clamp 3, the next
    # node 2, the weights 2, three channels 3 each
    "ref_row": 4 + 1 + 3 + 2 + 2 + 3 * 3,
    # the world-frame bicycle without its tyre forces: vxs 1, alpha_f 4,
    # alpha_r 3, L 1, fzf 4, fzr 4, sin/cos of delta and psi 4, dvx 9, dvy
    # 5, dwz 5, dX 3, dY 3
    "f_world": sum((1, 4, 3, 1, 4, 4, 4, 9, 5, 5, 3, 3)),
}


def window_cells(setup) -> int:
    return max(2, int(setup.window_m / setup.track_ds))


def ekf_ops(setup) -> int:
    """The EKF: ``n_sub_ekf`` sub-steps of NX + 1 model evaluations, the
    Jacobian and F = (I + h J) F (dense); F P F' + q, the innovation, its
    Gauss-Jordan inverse (per pivot a reciprocal, the pivot row 2 NX, the
    other rows' 2 NX multiply-adds), K, the mean, (I - K) P- and its
    symmetrization."""
    f = SCALAR_OPS["f_dynamic"] + tyre_ops(setup.core.tire)
    mm = 2 * NX ** 3
    sub = (NX + 1) * f + RACE_OPS["ekf_sub"] + mm
    gj = NX * (1 + 2 * NX + (NX - 1) * 2 * 2 * NX)
    gate = 4 * NX if setup.gate_sigma > 0 else 0
    return (setup.n_sub_ekf * sub + 2 * mm + 3 * NX + gate + gj + mm + 2 * NX * NX + NX * NX + mm
            + 2 * NX * NX)


def measure_ops(setup) -> int:
    return RACE_OPS["hint"] + (2 * window_cells(setup) + 1) * RACE_OPS["candidate"] + RACE_OPS["project"]


def world_plant_ops(setup) -> int:
    c = setup.core
    return c.n_sub * (RACE_OPS["f_world"] + tyre_ops(c.sim_tire) + 2 * NX)


def step_ops(setup, iters: float) -> float:
    """Operations per lane of one composed step at a mean of ``iters``
    ADMM iterations, whatever computes it."""
    c = setup.core
    return (measure_ops(setup) + ekf_ops(setup) + RACE_OPS["rls"] + (c.N + 1) * RACE_OPS["ref_row"]
            + core_ops(structure(c), c.tire, c.N, iters) + world_plant_ops(setup))


def bytes_per_lane(N: int) -> int:
    """The carry in and out (xg, ekx, ekP, fr, x_prev_f, X_pred, U_pred,
    s, lam, u_prev, rho), the noise, mu and the vehicle rows read, z and
    the stats rows written."""
    carry = NX + NX + NX * NX + 2 + NX + (N + 1) * NX + N * NU + 2 * NC * (N + 1) + NU + 1
    return 4 * (2 * carry + NX + 1 + 10 + NX + 8)


def per_launch(setup, lanes: int, iters: float, n_cells: int):
    """(operations, bytes) of one launch; the tables every lane shares (the
    curvature, the pose X, Y, psi, the reference table's three channels,
    the EKF's q and r) are read once per launch (each lane's search window
    reads the pose table again from the caches)."""
    n_ref = max(int(round(n_cells * setup.track_ds / setup.table_ds)), 8)
    shared = 4 * n_cells + 3 * n_ref + 2 * NX + 4
    return lanes * step_ops(setup, iters), lanes * bytes_per_lane(setup.core.N) + 4 * shared
