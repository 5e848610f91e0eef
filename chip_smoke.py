#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ops/csrc`` with nvcc, holds
each against its plain PyTorch version on the card (the megastep and the
racestep also with an obstacle corridor, the racestep with per-lane
reference tables and at the race presets' N=12 for B=4096 and B=1), then
drives seven main paths and the planner:

- the batched receding-horizon tracker of ``bench.py``: B=4096 scenarios of
  the dynamic bicycle on the racetrack, N=20, dt=1/30, constant reference
  vx=1.8, ``make_scenario_grid(n_ey=64, n_mu=64, vx0=1.5)``,
  ``SolverConfig(max_iter=20, rho_interval=0, early_exit=True,
  check_termination=2)``, 4 Euler plant sub-steps, one megastep launch per
  control step — for K=500 steps, followed by a few steps of the same
  controller routed through the solver-only kernel
  (``mpc_step_batched(backend="admm")`` + ``plant_step``);
- the composed deployment step of ``tools/racebench.py``: B=4096 cars on
  the racetrack, ``MPCConfig(N=20, tire="pacejka")``, the same solver
  config, ``initial_table(ds=0.05, vx0=1.5)`` references, plant friction
  ``linspace(0.5, 1.2, B)``, controller seed mu0=0.85, vx0=1.5 with s spread
  over the lap, sensor noise sigma = (0.03, 0.01, 0.02, 0.01, 0.02, 0.01),
  EKF with 4 sub-steps, friction adaptation, 10 world-plant sub-steps — for
  K=500 steps through ``make_racestep_scan``, one racestep launch per step;
- ``bench.py``'s fused protocol (``python bench.py 4096 fused``): the
  tracker of the first path through ``mpc_step_batched(backend="fused")`` +
  ``plant_step``, ``SolverConfig(max_iter=20, rho_interval=0,
  early_exit=False, check_termination=2)``, one fused launch per step, K=500;
- BASELINE config 1 batched: the kinematic bicycle, N=10, on the oval,
  constant reference vx=1.5, a 64 x 64 grid of initial e_y and friction
  from vx0=0.5 — K=500 steps through the fused path, then K=500 through
  the kinematic megastep, then a few steps through the solver-only kernel;
- the composed protocol racing moving opponents (``race_loop``'s mega
  segments without the planner): the second path's cars, each with its own
  reference table (vx scaled by sqrt(mu_true / 1.2)), three opponents
  (s0 = 0.2, 0.5, 0.8 of the lap, e_y = 0.15, -0.15, 0, v = 0.8, 1.0, 0.6)
  whose swept blocks (``opponents_obstacle_fn``, padded to 8 rows) are
  refreshed every 60 steps, 9 segments through ``make_racestep_scan(...,
  table_arg=True, obstacles_arg=True)``: one racestep launch per step with
  the e_y corridor operand; then the same with all-dummy blocks;
- ``[plan]``: the MPP planner (``plan_mpp``) on the card at the race
  presets' ``MPPConfig.for_model("dynamic", H=256, n_sqp=2)`` on the
  racetrack at mu=0.5, eager and from its CUDA graphs, against the same
  plan by the port on the CPU; then BASELINE config 3's default
  ``MPPConfig()`` (H=512, n_sqp=4) at mu=1.0;
- ``race_sweep``'s protocol (path 6): B=4096 cars for T=600 steps on the
  ``[plan]`` table through ``mega_race_sweep``, ``MPCConfig(N=12,
  tire="pacejka")``, ``SolverConfig(max_iter=40, early_exit=True,
  check_termination=2)``, plant friction ``linspace(0.5, 1.2, 4096)``,
  controller seed mu0=0.85, the sensor noise above: one racestep launch per
  step;
- the flagship ``race`` preset (path 7): ``race_loop(backend="mega")``,
  T=720 on the racetrack, mu_true=0.6, mu0=1.0, the planner above
  replanning every 60 steps from the EKF's state at the live mu-hat,
  N=12 Pacejka, ``max_iter=60``: one racestep launch per step at B=1; then
  120 steps of the same program with ``backend="plain"`` (no kernel).

The new paths build their tracks, grids and references without naming a
device: the port's default device is the card. The ``kernels`` line has
one record per kernel instantiation (the megastep, the fused kernel and the
solver-only kernel each for the dynamic and the kinematic model, and the
racestep), each with its launches on
its main path and its bound on the H100: the larger of the operations the
algorithm needs over 67 TFLOP/s f32 and its bytes over 3.35 TB/s, counted
at this run's shapes and executed iterations (see the counters below).
Every record's ``ms`` is CUDA-event time around the wrapper: the main
path's ms per step for the step kernels (megastep, racestep), one isolated
call for the solves (admm, fused). ``device_ms`` is the kernel's own
duration on one isolated call (the first step for the step kernels), from
torch.profiler. The ``[main]`` line also gives the device time per step of
the megastep path (the kernel's and every device operation's), so that the
host's share of the step shows.

Every phase either passes or ends the run with a non-zero exit. The last
two lines of standard output are a JSON line with one record per kernel and
the JSON result line. ``--quick`` stops after the kernel comparisons (a
first check of freshly edited kernels) and prints no result.

``--ab`` measures an older checkout of the port the same way: copy this
script to that checkout's root and run it there with ``--ab``. It skips
the ``[shape]`` lines (the group kernels' launch shape, which older
checkouts lack), the solver-only kernel at na=6, the corridor and per-lane
table phases, the fifth path, the racestep at N=12, the planner and paths
6 and 7 (which they do not take), and runs every other phase. A one-call A/B of a change
runs the parent's copy and the change's script in turn (parent, change,
change, parent) and compares their lines.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "autonomous_racing_lpv_mpp_mpc_tpu_torch"
B_MAIN = 4096
N_MAIN = 20
K_MAIN = 500
K_ADMM_ROUTE = 5
K_RACE_CMP = 5
K_FUSED_WARM = 50
K_OBS_CMP = 3          # racestep steps held against plain with eyb and per-lane tables
OBS_SEGMENT = 60       # steps between block refreshes on main path 5
K_OBS_SEGMENTS = 9
SIGMA = (0.03, 0.01, 0.02, 0.01, 0.02, 0.01)
N_RACE = 12            # the race presets' tracker horizon (paths 6 and 7)
T_SWEEP = 600          # path 6: race_sweep's steps
T_RACE = 720           # path 7: the race preset's steps
T_RACE_PLAIN = 120     # path 7's smoke of the module composition on the card
REPLAN_EVERY = 60
# the TPU run's quality numbers (PERF_TPU.md:117-133), printed beside ours
TPU_SWEEP = {"corr": 0.956, "converged": 0.989, "ey_p99": 0.114}
TPU_RACE = {"mu_hat": 0.595, "lap_s": 13.97, "ey_rms": 0.043, "converged": 0.965}
H100_F32_FLOPS = 67e12      # f32 outside the tensor cores, SXM, 700 W
H100_BYTES_S = 3.35e12      # HBM3


# ---- operations and bytes per lane that the algorithm needs, at this run's
# shapes and iteration counts. A multiply-add counts 2; an add, multiply,
# division, compare, square root or transcendental counts 1. A product with
# a matrix whose zero pattern is fixed counts only its structural
# multiply-adds: the constant +-1 selector rows D = [Dx Du]
# (ops/fused_kernel.py::_make_consts) cost only the additions where two of
# their entries meet in one output, and the LPV (A, B) and the discrete
# (Ad, Bd) count the nonzeros that the plain stage build leaves. The Riccati
# cost-to-go, the gains and the EKF covariances count dense. Bytes: each
# input read once, each output written once. ----

NU, NC = 2, 6

# Scalar code, counted statement by statement in source order.
SCALAR_OPS = {
    # arl_common.cuh::kap_at: divide, floor, multiply, subtract, multiply, clamp 2
    "kap_at": 7,
    # arl_common.cuh::ab_cont_dynamic: vxs 1, sin/cos of delta and e_psi 4,
    # den 3, A00 3, A01 4, A02 3, A11 3, A12 6, A21 6, A22 7, A30 2, A31 2,
    # A40 1, A41 1, A53 (vxs sinc) 5, B00 2, B10 2, B20 3
    "ab_cont_dynamic": sum((1, 4, 3, 3, 4, 3, 3, 6, 6, 7, 2, 2, 1, 1, 5, 2, 2, 3)),
    # arl_common.cuh::secant_stiffness, Pacejka: fzf 5, fzr 4, af 4, ar 3,
    # the two slip floors 2, Bf 3, Br 3, Cf 6, Cr 6
    "secant_pacejka": sum((5, 4, 4, 3, 2, 3, 3, 6, 6)),
    # arl_common.cuh::ab_cont_kinematic: vxs 1, L 1, sin/cos 2, den 3, A00 3,
    # A10 2, A20 1, A31 5, B10 1
    "ab_cont_kinematic": sum((1, 1, 2, 3, 3, 2, 1, 5, 1)),
    # arl_common.cuh::f_dynamic: vxs 1, alpha_f 4, alpha_r 3, L 1, fzf 4,
    # fzr 4, sin/cos 4, denom 3, sdot 4, dx0 9, dx1 5, dx2 5, dx3 2, dx5 3;
    # the tyre forces (linear 2, Pacejka 16) are added by tyre_ops
    "f_dynamic": sum((1, 4, 3, 1, 4, 4, 4, 3, 4, 9, 5, 5, 2, 3)),
    # arl_common.cuh::f_kinematic: L 1, psidot 5, sin/cos 2, denom 3, sdot 2,
    # dx0 4, dx1 2, dx3 1
    "f_kinematic": sum((1, 5, 2, 3, 2, 4, 2, 1)),
    # racestep_kernel.cu::f_global: vxs 1, alpha_f 4, alpha_r 3, L 1, fzf 4,
    # fzr 4, sin/cos 4, dx0 9, dx1 5, dx2 5, dx3 3, dx4 3; tyres by tyre_ops
    "f_global": sum((1, 4, 3, 1, 4, 4, 4, 9, 5, 5, 3, 3)),
    # group_core.cuh::prepare_g, per stage: the friction-circle vx cap (multiply
    # 2, max, divide, square root, clamp 2), the vx-reference clamp 1
    "stage_cap": 8,
    # arl_common.cuh::converged: max, multiply-add 2 x 2, multiply, compare 2
    "converged": 8,
    # group_core.cuh::mpc_core_g section 7: r_dual 1, eps_prim 3, eps_dual 2,
    # conv 2, ratio 8, rho_new 3, rho_next 3
    "core_tail": sum((1, 3, 2, 2, 8, 3, 3)),
    # racestep_kernel.cu::measure outside the window loop: ds 1, hint cell
    # (wrap 4, multiply 1), cos/sin 2, ddx/ddy 2, along 3, e_y 3, s_w 6,
    # kap_at 7, dpsi 3, e_psi 3, lap 4, z[4] 2; then the noise 6
    "measure": sum((1, 4, 1, 2, 2, 3, 3, 6, 7, 3, 3, 4, 2, 6)),
    # racestep_kernel.cu::measure, per window cell: dx, dy 2, d2 3, compare 1
    "measure_cell": 6,
    # racestep_kernel.cu::friction_rls: midpoints 6, y1 5, y2 3, L 1, cos
    # and floor 2, vxs 1, y_m 7, slips 7, loads 6; per axle (x2):
    # pacejka_mu_sensitivity 18, excitation gate 2, gain 4, mu 5, P 4
    "friction_rls": sum((6, 5, 3, 1, 2, 1, 7, 7, 6)) + 2 * sum((18, 2, 4, 5, 4)),
    # racestep_kernel.cu::table_refs, per row: wrap 4, scale 1, t and
    # 1 - t 2, three interpolations 9
    "table_row": sum((4, 1, 2, 9)),
}


def tyre_ops(tire):
    """Axle forces inside f_dynamic / f_global: linear 2; Pacejka Bf 3,
    Br 3, fyf 5, fyr 5."""
    return 16 if tire == "pacejka" else 2


def pat(P, Q):
    """Zero pattern of the product of two zero patterns."""
    return (P.astype(np.int64) @ Q.astype(np.int64)) > 0


def pmm(P, Q):
    """Operations of the product of two zero patterns: 2 per structural
    multiply-add."""
    return 2 * int((P.astype(np.int64) @ Q.astype(np.int64)).sum())


def sel(D):
    """Operations of y = D v for a +-1 selector D: its additions."""
    return int(D.sum() - D.any(axis=1).sum())


def ones(r, c):
    return np.ones((r, c), dtype=bool)


class Structure(NamedTuple):
    """Zero patterns of one model's stage: the continuous A (nx, nx) and
    B (nx, NU), the augmented discrete Aa = [[Ad 0] [0 0]] (na, na) and
    Ba = [[Bd] [I]] (na, NU); the selector rows D = [Dx Du] (NC, na + NU);
    the number of soft rows."""
    A: np.ndarray
    B: np.ndarray
    Aa: np.ndarray
    Ba: np.ndarray
    D: np.ndarray
    soft: int


def vanloan_ops(A, B):
    """arl_common.cuh::vanloan on the top blocks [Ad Bd]: the scaling, 5
    Horner steps and 4 squarings, each product at the patterns its operands
    have at that step. Returns (ops, Ad pattern, Bd pattern)."""
    nx = A.shape[0]
    eye = np.eye(nx, dtype=bool)
    Ad, Bd = A | eye, B.copy()
    ops = 2 * int(A.sum()) + nx + 2 * int(B.sum())
    for _ in range(5):
        T, Tb = pat(A, Ad), pat(A, Bd)
        ops += pmm(A, Ad) + pmm(A, Bd) + int(T.sum()) + nx + 2 * int((Tb | B).sum())
        Ad, Bd = T | eye, Tb | B
    for _ in range(4):
        ops += pmm(Ad, Ad) + pmm(Ad, Bd) + int(Bd.sum())
        Ad, Bd = pat(Ad, Ad), pat(Ad, Bd) | Bd
    return ops, Ad, Bd


def stage_build_ops(S, tire):
    """One stage's LPV (A, B) and its Van Loan discretization."""
    nx = S.A.shape[0]
    lpv = (SCALAR_OPS["ab_cont_kinematic"] if nx == 4 else
           SCALAR_OPS["ab_cont_dynamic"] + (SCALAR_OPS["secant_pacejka"] if tire == "pacejka" else 0))
    return lpv + vanloan_ops(S.A, S.B)[0]


def fold_ops(S):
    """The rho-folded cost blocks Qc + rho DxDx, Qtc + rho DxDx, Rc + rho
    DuDu, Mc + rho DxDu, once per solve."""
    na = S.Aa.shape[0]
    Dx, Du = S.D[:, :na], S.D[:, na:]
    return 2 * (2 * int(pat(Dx.T, Dx).sum()) + int(pat(Du.T, Du).sum()) + int(pat(Dx.T, Du).sum()))


def factor_ops(Aa, Ba, c=None):
    """One stage of the backward Riccati factor (group_core.cuh::factor_g;
    admm_kernel.cu::factor_dense_g, which adds V c)."""
    na, nu = Ba.shape
    V = ones(na, na)
    VA = pat(V, Aa)
    ops = (pmm(V, Ba) + pmm(Ba.T, ones(na, nu)) + nu * nu       # V Ba, Huu = Rf + Ba' V Ba
           + pmm(V, Aa) + pmm(Ba.T, VA) + nu * na               # V Aa, Hux = Mf' + Ba' V Aa
           + 8 + pmm(ones(nu, nu), ones(nu, na))                # inv2, K = -Huu^-1 Hux
           + pmm(Aa.T, VA) + pmm(ones(na, nu), ones(nu, na))    # Aa' V Aa, Hux' K
           + 2 * na * na + na * (na - 1))                       # V = Qf + ..., symmetrize
    return ops + (0 if c is None else pmm(V, c[:, None]))


def iteration_ops(S, N, c=None):
    """One ADMM iteration over N stages and the terminal one
    (group_core.cuh::admm_iteration_g with its z-update;
    admm_kernel.cu::admm_iteration_dense_g with its affine term c), with the
    termination test."""
    Aa, Ba = S.Aa, S.Ba
    na, nu = Ba.shape
    D, Dx = S.D, S.D[:, :na]
    ncol, ncol_x = int(D.any(axis=0).sum()), int(Dx.any(axis=0).sum())
    col = ones(na, 1)
    back = (2 * NC + sel(D.T) + 2 * (na + nu) + 2 * ncol                  # v, D'v, q, r
            + pmm(Ba.T, col) + nu + pmm(ones(nu, nu), ones(nu, 1))       # hu, d
            + pmm(Aa.T, col) + pmm(ones(na, nu), ones(nu, 1)) + 2 * na)  # v_k
    back_n = 2 * NC + sel(Dx.T) + 2 * na + 2 * ncol_x
    # z-update per row: w_rel 3, wl 2, clamp 2, lam 3, |G - s| max 2, |G|
    # max 1, |s| max 1, ds 1; a soft row adds its prox 4; then the dual
    # norms D'ds and D'lam with their maxima
    z = sel(D) + 15 * NC + 4 * S.soft + 2 * sel(D.T) + 2 * ncol
    z_n = sel(Dx) + 15 * NC + 4 * S.soft + 2 * sel(Dx.T) + 2 * ncol_x
    fwd = pmm(ones(nu, na), col) + nu + pmm(Aa, col) + pmm(Ba, ones(nu, 1)) + z
    aff = 0 if c is None else na + int(c.sum())                             # w = Vc + v; x += c
    return N * (back + fwd + aff) + back_n + z_n + SCALAR_OPS["converged"]


def core_ops(S, tire, N, iters):
    """group_core.cuh::mpc_core_g: per stage the curvature, friction cap,
    reference clamp, linear cost and warm-start clip; N stage builds; the
    folded cost; N factor stages; `iters` iterations; residuals and rho.
    The limp-home branch, which no converged lane takes, is not counted."""
    nx = S.A.shape[0]
    per_stage = SCALAR_OPS["kap_at"] + SCALAR_OPS["stage_cap"] + nx + 2 * NC
    return (N * stage_build_ops(S, tire) + (N + 1) * per_stage + fold_ops(S)
            + N * factor_ops(S.Aa, S.Ba) + iters * iteration_ops(S, N) + SCALAR_OPS["core_tail"])


def fused_ops(S, tire, N, iters):
    """fused_kernel.cu: N stage builds, the linear cost and warm-start clip,
    the folded cost, N factor stages, `iters` iterations, r_dual."""
    nx = S.A.shape[0]
    return (N * stage_build_ops(S, tire) + (N + 1) * (nx + 2 * NC) + fold_ops(S)
            + N * factor_ops(S.Aa, S.Ba) + iters * iteration_ops(S, N) + 1)


def plant_ops(S, tire, n_sub):
    """megastep_kernel.cu section 9: n_sub Euler sub-steps of the Frenet
    plant, each with its curvature lookup."""
    nx = S.A.shape[0]
    f = SCALAR_OPS["f_kinematic"] if nx == 4 else SCALAR_OPS["f_dynamic"] + tyre_ops(tire)
    return n_sub * (f + SCALAR_OPS["kap_at"] + 2 * nx)


def ekf_ops(n_sub_ekf, tire, gate):
    """racestep_kernel.cu::ekf: per sub-step the curvature, 7 model
    evaluations, the perturbed states, G = I + h J, F = G F (the first
    product is with I and needs nothing) and the Euler update; then
    Pp = F P F' + diag(q), the innovation, the optional gate, S, its inverse
    (n^3 multiply-adds), K = Pp S^-1, x += K nu, P = sym((I - K) Pp)."""
    n = 6
    f = SCALAR_OPS["f_dynamic"] + tyre_ops(tire)
    sub = SCALAR_OPS["kap_at"] + (n + 1) * f + n + (3 * n * n + n) + 2 * n
    update = (2 * _mm(n, n, n) + n + n + (6 * n if gate else 0) + n + 2 * n ** 3
              + _mm(n, n, n) + _mm(n, n, 1) + n + _mm(n, n, n) + n * (n - 1))
    return n_sub_ekf * sub + (n_sub_ekf - 1) * _mm(n, n, n) + update


def race_ops(S, N, iters, n_sub_ekf, n_sub, window, gate):
    """racestep_kernel.cu: measurement over `window` cells, EKF, friction
    RLS, the reference rows, the core at Pacejka tyres, n_sub world-plant
    Euler sub-steps."""
    world = SCALAR_OPS["f_global"] + tyre_ops("pacejka") + 2 * 6
    return (SCALAR_OPS["measure"] + window * SCALAR_OPS["measure_cell"]
            + ekf_ops(n_sub_ekf, "pacejka", gate) + SCALAR_OPS["friction_rls"]
            + (N + 1) * SCALAR_OPS["table_row"] + core_ops(S, "pacejka", N, iters) + n_sub * world)


def _mm(r, k, l):
    return 2 * r * k * l


def fused_bytes(nx, N):
    """Inputs xs, us, kap, xref, prm, lb, ub, x0a, s0, lam0, rho read once;
    X, U, s, lam, stats written once."""
    na = nx + 2
    ins = N * nx + 2 * N + N + (N + 1) * nx + 10 + 4 * 6 * (N + 1) + na + 1
    outs = (N + 1) * na + 2 * N + 2 * 6 * (N + 1) + 8
    return 4 * (ins + outs)


def mega_bytes(nx, N, eyb=False):
    """Carry in and out (x, X_pred, U_pred, s, lam, u_prev), rho, xref, prm,
    stats, and the (N+1, 2) e_y corridor where one is given (the shared
    curvature table is added per call)."""
    carry = nx + (N + 1) * nx + 2 * N + 2 * 6 * (N + 1) + 2
    return 4 * (2 * carry + 1 + (N + 1) * nx + 10 + 8 + (2 * (N + 1) if eyb else 0))


def race_bytes(N, eyb=False, per_lane=False):
    """The race carry in and out (xg, ekx, ekP, fr, x_prev, X_pred, U_pred,
    s, lam, u_prev), noise, xf, z, mu_true, rho, prm, stats; the (N+1, 2)
    e_y corridor where one is given; with per-lane tables the lane's own
    table nodes that its N+1 reference rows sample (two nodes per row in
    each of 3 channels: what this step needs of its 3 x n_ref row). The
    shared tables are added per call."""
    carry = 6 + 6 + 36 + 2 + 6 + (N + 1) * 6 + 2 * N + 2 * 6 * (N + 1) + 2
    extra = (2 * (N + 1) if eyb else 0) + (2 * 3 * (N + 1) if per_lane else 0)
    return 4 * (2 * carry + 6 + 6 + 1 + 1 + 10 + 8 + extra)


def admm_bytes(N, na):
    """A, B, c, Qf, q, Rf, r, Mf, lb, ub, x0, s0, lam0, rho in; X, U, s,
    lam, stats out (the shared selector rows are added per call)."""
    ins = N * (na * na + 3 * na + 4 + 2 + 2 * na) + (N + 1) * (na * na + na) + 4 * 6 * (N + 1) + na + 1
    outs = (N + 1) * na + 2 * N + 2 * 6 * (N + 1) + 8
    return 4 * (ins + outs)


def bound(ops, nbytes):
    """(ms, what sets it): the least time the H100 could take for `ops`
    f32 operations and `nbytes` bytes of device-memory traffic."""
    t_ops, t_bytes = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def model_structure(p, cfg, scfg):
    """The zero patterns of cfg's stage for the vehicle p, from the port's
    plain stage build at 64 random scheduling points, and its selector rows
    and soft rows."""
    import torch

    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.fused_kernel import _make_consts
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.stage_math import (
        _ab_cont_dynamic, _ab_cont_kinematic, model_dims, stack_params, stage_aug_ab,
        unpack_params,
    )

    nx, _ = model_dims(cfg.model)
    g = torch.Generator().manual_seed(0)
    x = 0.5 + torch.rand((nx, 64), generator=g)
    u = 0.2 * torch.rand((NU, 64), generator=g) - 0.1
    kap = 0.5 * torch.rand((64,), generator=g) - 0.25
    pv = unpack_params(stack_params(p, 64, "cpu"))
    if cfg.model == "kinematic":
        A, B = _ab_cont_kinematic(x, u, kap, pv)
    else:
        A, B = _ab_cont_dynamic(x, u, kap, pv, cfg.tire)
    Aa, Ba = stage_aug_ab(x, u, kap, pv, dt=cfg.dt, tire=cfg.tire, model=cfg.model)
    nz = lambda t: (t != 0).any(dim=-1).numpy()
    k = _make_consts(cfg, scfg)
    D = np.concatenate([k.Dx.numpy() != 0, k.Du.numpy() != 0], axis=1)
    S = Structure(nz(A), nz(B), nz(Aa), nz(Ba), D, int(np.isfinite(k.soft.numpy()).sum()))
    _, Ad, Bd = vanloan_ops(S.A, S.B)
    check(np.array_equal(Ad, S.Aa[:nx, :nx]) and np.array_equal(Bd, S.Ba[:nx]),
          f"{cfg.model}: the Van Loan pattern count disagrees with the plain stage build")
    return S


def executed_iters(done_at):
    """Mean ADMM iterations a lane ran under the 128-lane early exit: its
    group's largest done-at (max_iter where a lane never converged);
    done_at (..., B) with B a multiple of 128."""
    return done_at.reshape(done_at.shape[:-1] + (-1, 128)).amax(dim=-1).float().mean().item()


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def log(*a):
    print(*a, flush=True)


def gpu_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, n):
    """Mean device time per call of fn over n calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_events(fn, n):
    """(name, microseconds) of every device operation in n calls of fn, from
    one torch.profiler session padded with 0.1 s of idle host time on both
    sides of the calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn, n, kernel, sessions=3):
    """Mean device time of one launch of the CUDA kernel whose name holds
    `kernel` over n calls of fn (torch.profiler: the kernel's own duration,
    without the wrapper's host work around it).

    The profiler has been seen to report fewer kernel records than launches
    that ran (1 of 10 on one H100 run; not reproduced in 160 sessions since).
    Each session is therefore padded with 0.1 s of idle host time on both
    sides of the calls, a session that reports fewer than n records is
    repeated, up to `sessions` in all, and the mean is taken over the
    records of the session that reported the most. A shortfall is logged;
    more records than calls (the name matches another kernel) or none at all
    fail."""
    best = []
    for s in range(sessions):
        dts = [us for name, us in device_events(fn, n) if kernel in name]
        check(len(dts) <= n, f"the profiler saw {len(dts)} launches of {kernel} in {n} calls")
        if len(dts) > len(best):
            best = dts
        if len(dts) == n:
            break
        log(f"[profiler] session {s + 1} of {sessions} reported {len(dts)} of {n} launches of {kernel}")
    check(best, f"the profiler reported no launch of {kernel} in {sessions} sessions of {n} calls")
    return sum(best) / len(best) / 1e3


def step_device_ms(fn, n, kernel):
    """(device ms of one launch of the kernel whose name holds `kernel`,
    device ms of every device operation per call) over n calls of fn."""
    ev = device_events(fn, n)
    ks = [us for name, us in ev if kernel in name]
    check(ks, f"the profiler reported no launch of {kernel} in {n} calls")
    return sum(ks) / len(ks) / 1e3, sum(us for _, us in ev) / n / 1e3


def ptxas_usage(build_log, *parts):
    """(registers, spill store bytes) that ptxas reported for the kernel
    entry whose mangled name holds every one of `parts`."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and all(q in line for q in parts):
            regs = spills = None
            for nxt in lines[i + 1:i + 5]:
                if "spill stores" in nxt:
                    spills = int(nxt.split("bytes spill stores")[0].split(",")[-1])
                if "Used" in nxt and "registers" in nxt:
                    regs = int(nxt.split("Used")[1].split("registers")[0])
            return regs, spills
    fail(f"no ptxas entry for {parts}")


def main():
    quick = "--quick" in sys.argv[1:]
    ab = "--ab" in sys.argv[1:]
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    try:
        port = __import__(PKG)
    except ImportError as e:
        fail(f"the port package {PKG} is not beside this script ({e})")
    check(os.path.dirname(os.path.abspath(port.__file__)) == os.path.join(HERE, PKG),
          f"{PKG} was imported from {port.__file__}, not from this checkout")

    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import (
        MPCConfig, MPCWeights, SolverConfig, VehicleParams,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
        DEFAULT_EKF_Q, MPCCarry, constant_refs, initial_table, make_racestep_scan, mpc_init,
        mpc_prepare, mpc_prepare_light, mpc_step_batched, plant_step,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.admm_kernel import (
        admm_kernel_solve, admm_solve_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.fused_kernel import (
        fused_mpc_solve, fused_solve_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import (
        megastep, megastep_init, megastep_params, megastep_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.racestep_kernel import (
        _win_cells, racestep, racestep_init, racestep_plain,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.stage_math import model_s_ey
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track, racetrack

    # ---- 1. environment ----
    card = gpu_name_power()
    dev = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[env] nvidia-smi: {card}")
    log(f"[env] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} precision={torch.get_float32_matmul_precision()}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    build_log = lib_path.with_suffix(".log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    # the launch shape of the group-cooperative kernels at the main paths' N
    if not ab:
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.admm_kernel import admm_launch_shape
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.fused_kernel import (
            LANES_PER_BLOCK, THREADS_PER_LANE, launch_shape,
        )
        for name, model, n_h, entry in (("megastep_kernel", "dynamic", N_MAIN, ("megastep_kernel", "Dynamic")),
                                        ("megastep_kernel_kinematic", "kinematic", 10, ("megastep_kernel", "Kinematic")),
                                        ("fused_kernel", "dynamic", N_MAIN, ("fused_kernel", "Dynamic")),
                                        ("fused_kernel_kinematic", "kinematic", 10, ("fused_kernel", "Kinematic")),
                                        ("racestep_kernel", "dynamic", N_MAIN, ("racestep_kernel",))):
            sh = launch_shape(n_h, model)
            regs, spills = ptxas_usage(build_log, *entry, f"Lb{int(sh.ops_in_smem)}E")
            log(f"[shape] {name} N={n_h}: {THREADS_PER_LANE} threads per lane, {LANES_PER_BLOCK} lanes "
                f"per block ({THREADS_PER_LANE * LANES_PER_BLOCK} threads), clusters of {sh.cluster} "
                f"blocks, {-(-B_MAIN // 128) * sh.cluster} blocks at B={B_MAIN}, "
                f"{sh.smem_bytes} B dynamic shared memory per block (operands in "
                f"{'shared' if sh.ops_in_smem else 'device'} memory), {regs} registers, {spills} B spill stores")
        for name, na, n_h in (("admm_kernel", 8, N_MAIN), ("admm_kernel_kinematic", 6, 10)):
            sh = admm_launch_shape(n_h, na)
            regs, spills = ptxas_usage(build_log, "admm_kernel", f"ILi{na}ELb{int(sh.ops_in_smem)}E")
            log(f"[shape] {name} na={na} N={n_h}: {THREADS_PER_LANE} threads per QP, {sh.lanes} QPs per "
                f"block ({THREADS_PER_LANE * sh.lanes} threads), no cluster, {-(-B_MAIN // sh.lanes)} blocks "
                f"at B={B_MAIN}, {sh.smem_bytes} B dynamic shared memory per block (operands in "
                f"{'shared' if sh.ops_in_smem else 'device'} memory), {regs} registers, {spills} B spill stores")

    # ---- shared setup: the bench protocol's scenarios ----
    p = VehicleParams()
    cfg = MPCConfig(N=N_MAIN, model="dynamic")
    track = racetrack(device=dev)
    x_ref = constant_refs(cfg, 1.8, device=dev)
    scen = make_scenario_grid(p, cfg, n_ey=64, n_mu=B_MAIN // 64, vx0=1.5, device=dev)
    B = scen.batch
    check(B == B_MAIN, f"scenario grid has {B} lanes")
    prm = megastep_params(scen.params, B, device=dev)
    # BASELINE config 1: the kinematic bicycle, N=10, on the oval
    kcfg = MPCConfig(N=10, model="kinematic", weights=MPCWeights.for_model("kinematic"))
    oval = oval_track()                                   # the default device: the card
    check(oval.kappa.is_cuda, f"oval_track() made tensors on {oval.kappa.device}, not the card")
    kscen = make_scenario_grid(p, kcfg, n_ey=64, n_mu=B_MAIN // 64, vx0=0.5)
    kprm = megastep_params(kscen.params, B_MAIN)
    kref = constant_refs(kcfg, 1.5)

    # ---- 3. kernel 1 (solver-only) vs its plain version, on the first step's
    # tracker QPs of both models (na=8 dynamic N=20, na=6 kinematic N=10) ----
    scfg1 = SolverConfig(max_iter=20, rho_interval=0)
    admm = {}   # name -> (qp, warm, rho, max |dU, dX|, events ms, device ms, plain ms)
    for name, acfg, atrack, ascen, aref in (("admm_kernel", cfg, track, scen, x_ref),
                                            ("admm_kernel_kinematic", kcfg, oval, kscen, kref)):
        if ab and acfg.model == "kinematic":
            continue
        acar = mpc_init(ascen.params, acfg, atrack, ascen.x0)
        qp, warm, _ = mpc_prepare(ascen.params, acfg, atrack, ascen.x0, aref, acar)
        ref = admm_solve_plain(qp, scfg1, warm, acar.rho)
        before = admm_kernel_solve.launches
        sol = admm_kernel_solve(qp, scfg1, warm, acar.rho)
        torch.cuda.synchronize()
        check(admm_kernel_solve.launches == before + 1, f"{name} was not launched")
        dU = (sol.U - ref.U).abs().max().item()
        dX = (sol.X - ref.X).abs().max().item()
        dr = (sol.r_prim - ref.r_prim).abs().max().item()
        n_da = int((sol.iters - ref.iters).ne(0).sum().item())
        da_max = int((sol.iters - ref.iters).abs().max().item())
        na = qp.Dx.shape[1]
        log(f"[admm] na={na} B={B} N={acfg.N} max|dU|={dU:.3e} max|dX|={dX:.3e} max|dr_prim|={dr:.3e} "
            f"done-at differs in {n_da} lanes (max {da_max}); converged {sol.converged.float().mean().item():.4f}")
        check(dU <= 2e-4 and dX <= 2e-4, f"admm kernel na={na}: U/X beyond 2e-4 of the plain version")
        check(dr <= 1e-4, f"admm kernel na={na}: r_prim beyond 1e-4 of the plain version")
        check(da_max <= 1, f"admm kernel na={na}: done-at differs by more than 1")
        solve = lambda: admm_kernel_solve(qp, scfg1, warm, acar.rho)
        admm[name] = (qp, warm, acar.rho, max(dU, dX), cuda_time_ms(solve, 10),
                      kernel_ms(solve, 10, "admm_kernel"),
                      cuda_time_ms(lambda: admm_solve_plain(qp, scfg1, warm, acar.rho), 3))
        log(f"[admm] na={na}: {admm[name][4]:.3f} ms/solve kernel (wrapper), {admm[name][5]:.4f} ms kernel "
            f"(device), {admm[name][6]:.3f} ms/solve plain ({card})")

    # ---- 4. kernel 2 (megastep) vs its plain version, 5 closed-loop steps ----
    mega_err = {}
    for name, scfg, tol_u, tol_x in (
        ("fixed", SolverConfig(max_iter=20, rho_interval=0, early_exit=False, check_termination=2), 2e-4, 5e-4),
        ("early-exit", SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2), 5e-3, 5e-3),
    ):
        ck = megastep_init(scen.params, cfg, track, scen.x0)
        cp = ck
        du = dx = 0.0
        for _ in range(5):
            ck, uk, dk = megastep(cfg, scfg, track, prm, x_ref, ck, n_sub=4)
            cp, up, dp = megastep_plain(cfg, scfg, track, prm, x_ref, cp, n_sub=4)
            torch.cuda.synchronize()
            du = max(du, (uk - up).abs().max().item())
            dx = max(dx, (ck.x - cp.x).abs().max().item())
        dXp = (ck.X_pred - cp.X_pred).abs().max().item()
        log(f"[mega] {name}: max|du|={du:.3e} max|dx|={dx:.3e} |dX_pred|={dXp:.3e} "
            f"done-at kernel {dk[4].mean().item():.3f} plain {dp[4].mean().item():.3f}")
        check(du <= tol_u and dx <= tol_x, f"megastep {name}: beyond ({tol_u}, {tol_x}) of plain")
        mega_err[name] = max(du, dx)
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    c0 = megastep_init(scen.params, cfg, track, scen.x0)
    megastep(cfg, scfg, track, prm, x_ref, c0, n_sub=4)            # warm-up
    mega_ms_iso = cuda_time_ms(lambda: megastep(cfg, scfg, track, prm, x_ref, c0, n_sub=4), 10)
    mega_dev_ms = kernel_ms(lambda: megastep(cfg, scfg, track, prm, x_ref, c0, n_sub=4), 10, "megastep_kernel")
    mega_plain_ms = cuda_time_ms(lambda: megastep_plain(cfg, scfg, track, prm, x_ref, c0, n_sub=4), 3)
    log(f"[mega] first step: {mega_ms_iso:.3f} ms kernel, {mega_dev_ms:.4f} ms kernel (device), "
        f"{mega_plain_ms:.3f} ms plain ({card})")

    # ---- 4b. the megastep's e_y corridor operand (obstacle blocks ahead of
    # the grid), 5 closed-loop steps; each step's corridor is made once from
    # the plain carry's schedule and handed to both versions ----
    mega_eyb = None
    if not ab:
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import corridor_eyb
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import pad_blocks

        # a block on the lower half of the corner ahead: the corridor moves
        # up, and most lanes still converge within 20 iterations
        mega_blocks = pad_blocks(np.array([[1.0, 2.0, -0.45, -0.1]], np.float32), 8)
        eyb_of = corridor_eyb(p, cfg, track, mega_blocks, device=dev)
        mega_eyb = {}
        for name, scfg_e, tol_u, tol_x in (
            ("fixed", SolverConfig(max_iter=20, rho_interval=0, early_exit=False, check_termination=2), 2e-4, 5e-4),
            ("early-exit", scfg, 5e-3, 5e-3),
        ):
            ck = cp = cf = megastep_init(scen.params, cfg, track, scen.x0)
            du = dx = 0.0
            for _ in range(5):
                e = eyb_of(cp.x[4], cp.X_pred[:, 4])
                ck, uk, dk = megastep(cfg, scfg_e, track, prm, x_ref, ck, n_sub=4, eyb=e)
                cp, up, dp = megastep_plain(cfg, scfg_e, track, prm, x_ref, cp, n_sub=4, eyb=e)
                cf, _, _ = megastep(cfg, scfg_e, track, prm, x_ref, cf, n_sub=4)
                torch.cuda.synchronize()
                du = max(du, (uk - up).abs().max().item())
                dx = max(dx, (ck.x - cp.x).abs().max().item())
            bind = (ck.x - cf.x).abs().max().item()
            log(f"[mega-eyb] {name}: max|du|={du:.3e} max|dx|={dx:.3e} done-at kernel {dk[4].mean().item():.3f} "
                f"plain {dp[4].mean().item():.3f}; |x - x without the corridor| max {bind:.3e}")
            check(du <= tol_u and dx <= tol_x, f"megastep with eyb {name}: beyond ({tol_u}, {tol_x}) of plain")
            check(bind > 1e-3, f"megastep with eyb {name}: the corridor did not bind ({bind:.3e})")
            mega_eyb[name] = max(du, dx)
        e0 = eyb_of(c0.x[4], c0.X_pred[:, 4])
        box = torch.tensor([-cfg.bounds.ey_max, cfg.bounds.ey_max], device=dev).reshape(1, 2, 1)
        box = box.expand(N_MAIN + 1, 2, B).contiguous()
        mega_eyb["box_dev_ms"] = kernel_ms(lambda: megastep(cfg, scfg, track, prm, x_ref, c0, n_sub=4, eyb=box),
                                           10, "megastep_kernel")
        mega_eyb["dev_ms"] = kernel_ms(lambda: megastep(cfg, scfg, track, prm, x_ref, c0, n_sub=4, eyb=e0),
                                       10, "megastep_kernel")
        log(f"[mega-eyb] first step, device: {mega_dev_ms:.4f} ms without eyb, {mega_eyb['box_dev_ms']:.4f} ms "
            f"with the box as eyb (the read alone), {mega_eyb['dev_ms']:.4f} ms with the corridor ({card})")

    # ---- 5. kernel 3 (racestep) vs its plain version: the composed protocol ----
    rcfg = MPCConfig(N=N_MAIN, model="dynamic", tire="pacejka")
    table = initial_table(track, ds=0.05, vx0=1.5)
    mu_b = torch.linspace(0.5, 1.2, B_MAIN, device=dev)
    x0r = torch.zeros((B_MAIN, 6), device=dev)
    x0r[:, 0] = 1.5
    x0r[:, 4] = torch.arange(B_MAIN, device=dev, dtype=torch.float32) * (float(track.length) / B_MAIN)
    p_nom = p.replace(mu=0.85)
    rprm = megastep_params(p_nom, B_MAIN, device=dev)
    sig = torch.tensor(SIGMA, device=dev)
    ekq = torch.tensor(DEFAULT_EKF_Q, device=dev)
    ekr = sig ** 2
    gen = torch.Generator(device=dev).manual_seed(0)
    noises = [sig[:, None] * torch.randn((6, B_MAIN), generator=gen, device=dev) for _ in range(K_RACE_CMP)]
    # Fixed count: the kernel-parity bounds hold on the lanes whose solves converged
    # at every compared step on both sides; on a lane that has not converged
    # after 20 iterations the iterate is still moving by up to its residual
    # (~1e-3), and rho adapted from float-noise dual residuals amplifies the
    # two versions' rounding there, so every lane is held to the solver
    # tolerance of 5e-3 (the early-exit bound).
    race_err = {}
    fixed = SolverConfig(max_iter=20, rho_interval=0, early_exit=False, check_termination=2)
    tight = {"u0": 2e-4, "xg": 5e-4, "ekx": 5e-4, "X_pred": 5e-4, "z": 5e-4, "fr": 1e-4}
    loose = dict.fromkeys(tight, 5e-3)
    for name, scfg_r, refs, gate, conv_bounds in (
        ("fixed", fixed, table, 0.0, tight),
        ("early-exit", scfg, table, 0.0, loose),
        ("fixed, constant refs, gate 3", fixed, constant_refs(rcfg, 1.5, device=dev), 3.0, tight),
    ):
        ck = cp = racestep_init(p, rcfg, track, x0r, 0.85)
        lane_err = {}
        conv_lanes = torch.ones(B_MAIN, dtype=torch.bool, device=dev)
        for k in range(K_RACE_CMP):
            a = (rcfg, scfg_r, track, rprm, refs)
            ck, uk, dk, zk = racestep(*a, ck, noises[k], mu_b, ekq, ekr, gate_sigma=gate)
            cp, up, dp, zp = racestep_plain(*a, cp, noises[k], mu_b, ekq, ekr, gate_sigma=gate)
            torch.cuda.synchronize()
            conv_lanes &= (dk[2] > 0.5) & (dp[2] > 0.5)
            for key, x, y in (("u0", uk, up), ("z", zk, zp)) + tuple(
                    (f, getattr(ck, f), getattr(cp, f)) for f in ("xg", "ekx", "ekP", "fr", "X_pred")):
                d = (x - y).abs().reshape(-1, B_MAIN).amax(dim=0)
                lane_err[key] = torch.maximum(lane_err[key], d) if key in lane_err else d
        err_all = {key: v.max().item() for key, v in lane_err.items()}
        err_conv = {key: (v[conv_lanes].max().item() if bool(conv_lanes.any()) else 0.0)
                    for key, v in lane_err.items()}
        n_conv = int(conv_lanes.sum().item())
        log(f"[race] {name}: lanes converged at every step {n_conv}/{B_MAIN}: "
            + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_conv.items()))
        log(f"[race] {name}: all lanes: " + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_all.items())
            + f" done-at kernel {dk[4].mean().item():.3f} plain {dp[4].mean().item():.3f}")
        check(n_conv >= 0.9 * B_MAIN, f"racestep {name}: only {n_conv} lanes converged throughout")
        for key, tol in conv_bounds.items():
            check(err_conv[key] <= tol,
                  f"racestep {name}: |d{key}| {err_conv[key]:.3e} beyond {tol} of plain (converged lanes)")
        for key, tol in loose.items():
            check(err_all[key] <= tol, f"racestep {name}: |d{key}| {err_all[key]:.3e} beyond {tol} of plain")
        race_err[name] = max(err_all[key] for key in tight)
    c0r = racestep_init(p, rcfg, track, x0r, 0.85)
    race_args = (rcfg, scfg, track, rprm, table, c0r, noises[0], mu_b, ekq, ekr)
    racestep(*race_args)                                              # warm-up
    race_ms_iso = cuda_time_ms(lambda: racestep(*race_args), 10)
    race_dev_ms = kernel_ms(lambda: racestep(*race_args), 10, "racestep_kernel")
    race_plain_ms = cuda_time_ms(lambda: racestep_plain(*race_args), 3)
    log(f"[race] first step: {race_ms_iso:.3f} ms kernel (wrapper), {race_dev_ms:.4f} ms kernel (device), "
        f"{race_plain_ms:.3f} ms plain ({card})")

    # ---- 5a. the racestep with per-lane tables and an obstacle corridor:
    # main path 5's inputs (each lane's table vx scaled by sqrt(mu_true /
    # 1.2), three opponents' swept blocks), its first K_OBS_CMP steps; each
    # step's corridor is made once from the plain carry and handed to both.
    # Two comparisons: the kernel and plain each on its own carry (the
    # racestep's bounds on the lanes converged throughout), and the kernel
    # from plain's carry, one step at a time (the same bounds on every
    # lane). The per-lane tables brake the low-friction cars hard on these
    # first steps and the corridor starts cars inside blocks, so about half
    # the lanes do not converge within 20 iterations; on those a 3e-5
    # difference of the carries moves u0 by up to 1.2e-3 and the world state
    # and the prediction by up to 5.0e-3 after 3 steps (NVIDIA H100 80GB HBM3):
    # the unconverged solve's sensitivity, not the kernel's error, which the
    # one-step comparison bounds on every lane (4e-6). ----
    obs = None
    if not ab:
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import corridor_eyb
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import (
            RefTable, collision_trace, opponents, opponents_obstacle_fn, pad_blocks,
        )

        nref = table.vx.shape[0]
        lanes_tab = RefTable(ds=table.ds.expand(B_MAIN), length=table.length.expand(B_MAIN),
                             vx=table.vx[None] * torch.sqrt(mu_b / 1.2)[:, None],
                             ey=table.ey.expand(B_MAIN, nref), delta=table.delta.expand(B_MAIN, nref))
        L = float(track.length)
        opp = opponents(s0=(0.2 * L, 0.5 * L, 0.8 * L), e_y=(0.15, -0.15, 0.0), v=(0.8, 1.0, 0.6))
        obs_fn = opponents_obstacle_fn(track, opp, rcfg.dt, replan_every=OBS_SEGMENT)
        blocks0 = pad_blocks(obs_fn(0), 8)
        eyb_of = corridor_eyb(p_nom, rcfg, track, blocks0, device=dev)
        obs = {"table": lanes_tab, "opp": opp, "obs_fn": obs_fn}
        ck = cp = racestep_init(p, rcfg, track, x0r, 0.85)
        lane_err, step_err, bound_lanes = {}, {}, 0
        conv_lanes = torch.ones(B_MAIN, dtype=torch.bool, device=dev)

        def worst(acc, key, x, y):
            d = (x - y).abs().reshape(-1, B_MAIN).amax(dim=0)
            acc[key] = torch.maximum(acc[key], d) if key in acc else d

        for k in range(K_OBS_CMP):
            e = eyb_of(cp.ekx[4], cp.X_pred[:, 4])
            bound_lanes = max(bound_lanes, int((e[:, 0] > -rcfg.bounds.ey_max).any(dim=0).sum().item()))
            a = (rcfg, fixed, track, rprm, lanes_tab)
            ck, uk, dk, zk = racestep(*a, ck, noises[k], mu_b, ekq, ekr, eyb=e)
            cs, us, _, zs = racestep(*a, cp, noises[k], mu_b, ekq, ekr, eyb=e)
            cp, up, dp, zp = racestep_plain(*a, cp, noises[k], mu_b, ekq, ekr, eyb=e)
            torch.cuda.synchronize()
            conv_lanes &= (dk[2] > 0.5) & (dp[2] > 0.5)
            for acc, c, u, z in ((lane_err, ck, uk, zk), (step_err, cs, us, zs)):
                for key, x, y in (("u0", u, up), ("z", z, zp)) + tuple(
                        (f, getattr(c, f), getattr(cp, f)) for f in ("xg", "ekx", "ekP", "fr", "X_pred")):
                    worst(acc, key, x, y)
        err_all = {key: v.max().item() for key, v in lane_err.items()}
        err_conv = {key: (v[conv_lanes].max().item() if bool(conv_lanes.any()) else 0.0)
                    for key, v in lane_err.items()}
        err_step = {key: v.max().item() for key, v in step_err.items()}
        n_conv = int(conv_lanes.sum().item())
        log(f"[race-eyb] per-lane tables ({B_MAIN} x {nref} nodes x 3 channels) and the corridor of "
            f"{int((blocks0[:, 0] <= blocks0[:, 1]).sum())} opponent blocks, bound on {bound_lanes} lanes: "
            f"lanes converged at every step {n_conv}/{B_MAIN}: "
            + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_conv.items()))
        log("[race-eyb] all lanes, each version on its own carry: "
            + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_all.items())
            + f" done-at kernel {dk[4].mean().item():.3f} plain {dp[4].mean().item():.3f}")
        log("[race-eyb] all lanes, one step from the same carry: "
            + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_step.items()))
        check(bound_lanes > 0, "racestep with eyb: the corridor bound no lane")
        check(n_conv >= 0.25 * B_MAIN, f"racestep with eyb: only {n_conv} lanes converged throughout")
        for key, tol in tight.items():
            check(err_conv[key] <= tol,
                  f"racestep with eyb: |d{key}| {err_conv[key]:.3e} beyond {tol} of plain (converged lanes)")
            check(err_step[key] <= tol,
                  f"racestep with eyb: |d{key}| {err_step[key]:.3e} beyond {tol} of plain (one step, all lanes)")
        obs["err"] = max(err_step[key] for key in tight)
        obs["err_own_carries"] = max(err_all[key] for key in tight)
        # device time of the first step, main path 5's solver config: shared
        # table without and with the box as eyb (the read alone), per-lane
        # tables, per-lane tables with the corridor
        e0 = eyb_of(c0r.ekx[4], c0r.X_pred[:, 4])
        box = torch.tensor([-rcfg.bounds.ey_max, rcfg.bounds.ey_max], device=dev).reshape(1, 2, 1)
        box = box.expand(N_MAIN + 1, 2, B_MAIN).contiguous()
        variants = (("box", table, box), ("per-lane", lanes_tab, None), ("per-lane+eyb", lanes_tab, e0))
        obs["dev_ms"] = {}
        for name, tab_v, e_v in variants:
            racestep(rcfg, scfg, track, rprm, tab_v, c0r, noises[0], mu_b, ekq, ekr, eyb=e_v)   # warm-up
            obs["dev_ms"][name] = kernel_ms(
                lambda: racestep(rcfg, scfg, track, rprm, tab_v, c0r, noises[0], mu_b, ekq, ekr, eyb=e_v), 10,
                "racestep_kernel")
        log(f"[race-eyb] first step, device: {race_dev_ms:.4f} ms shared table, "
            + ", ".join(f"{v:.4f} ms {k}" for k, v in obs["dev_ms"].items()) + f" ({card})")
        obs["plain_ms"] = cuda_time_ms(
            lambda: racestep_plain(rcfg, scfg, track, rprm, lanes_tab, c0r, noises[0], mu_b, ekq, ekr, eyb=e0), 3)

    # ---- 5b. kernel 4 (fused) vs its plain version, on prepared inputs after
    # K_FUSED_WARM steps of the fused path: the bench's dynamic racetrack N=20
    # and BASELINE config 1's kinematic oval N=10. Fixed count: 2e-4 on lanes
    # converged on both sides, 5e-3 on every lane (see the racestep's
    # comment), done-at within one iteration; early exit: 5e-3 ----
    fused_fixed = SolverConfig(max_iter=20, rho_interval=0, backend="fused", early_exit=False,
                               check_termination=2, certify_infeasibility=False)
    fused_err, fused_iso, fused_args = {}, {}, {}
    for name, fcfg, ftrack, vref in (("dynamic", cfg, track, 1.8), ("kinematic", kcfg, oval, 1.5)):
        fscen = make_scenario_grid(p, fcfg, n_ey=64, n_mu=B_MAIN // 64, vx0=1.5)
        fref = constant_refs(fcfg, vref)
        fcar, fx = mpc_init(fscen.params, fcfg, ftrack, fscen.x0), fscen.x0
        for _ in range(K_FUSED_WARM):
            u, fcar, _ = mpc_step_batched(fscen.params, fcfg, fused_fixed, ftrack, fx, fref, fcar)
            fx = plant_step(fscen.params, fcfg, ftrack, fx, u, n_sub=4)
        Xs, Us, kap, xr, lb, ub, x0a, warm = mpc_prepare_light(fscen.params, fcfg, ftrack, fx, fref, fcar)
        fargs = (fscen.params, Xs, Us, kap, xr, lb, ub, x0a, warm[0], warm[1], fcar.rho)
        for mode, fs in (("fixed", fused_fixed), ("early-exit", fused_fixed.replace(early_exit=True))):
            sk = fused_mpc_solve(fcfg, fs, *fargs)
            sp = fused_solve_plain(fcfg, fs, *fargs)
            torch.cuda.synchronize()
            lane = torch.maximum((sk.U - sp.U).abs().amax(dim=(1, 2)), (sk.X - sp.X).abs().amax(dim=(1, 2)))
            both = sk.converged & sp.converged
            e_conv = lane[both].max().item() if bool(both.any()) else 0.0
            e_all = lane.max().item()
            dda = int((sk.iters - sp.iters).abs().max().item())
            log(f"[fused] {name} N={fcfg.N} {mode}: converged both {int(both.sum())}/{B_MAIN}: "
                f"max|dU,dX| {e_conv:.3e}; all lanes {e_all:.3e}; |dr_prim| "
                f"{(sk.r_prim - sp.r_prim).abs().max().item():.3e}; done-at kernel "
                f"{sk.iters.float().mean().item():.3f} plain {sp.iters.float().mean().item():.3f} "
                f"(max diff {dda})")
            if mode == "fixed":
                check(e_conv <= 2e-4, f"fused {name}: {e_conv:.3e} beyond 2e-4 of plain (converged lanes)")
                check(dda <= 1, f"fused {name}: done-at differs by {dda}")
            check(e_all <= 5e-3, f"fused {name} {mode}: {e_all:.3e} beyond 5e-3 of plain")
            fused_err[(name, mode)] = e_all
        # (wrapper ms, device ms, plain ms)
        fused_iso[name] = (cuda_time_ms(lambda: fused_mpc_solve(fcfg, fused_fixed, *fargs), 20),
                           kernel_ms(lambda: fused_mpc_solve(fcfg, fused_fixed, *fargs), 20, "fused_kernel"),
                           cuda_time_ms(lambda: fused_solve_plain(fcfg, fused_fixed, *fargs), 3))
        log(f"[fused] {name} B={B_MAIN} N={fcfg.N}: {fused_iso[name][0]:.3f} ms/solve kernel (wrapper), "
            f"{fused_iso[name][1]:.4f} ms/solve kernel (device), {fused_iso[name][2]:.3f} ms/solve plain "
            f"({card})")
        fused_args[name] = (fcfg, fused_fixed, *fargs)
    check(fused_mpc_solve.launches > 0, "the fused kernel was not launched")

    # ---- 5c. the kinematic megastep vs its plain version, 5 closed-loop steps ----
    for name, kscfg, tol_u, tol_x in (
        ("fixed", SolverConfig(max_iter=20, rho_interval=0, early_exit=False, check_termination=2), 2e-4, 5e-4),
        ("early-exit", SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2), 5e-3, 5e-3),
    ):
        ck = cp = megastep_init(kscen.params, kcfg, oval, kscen.x0)
        du = dx = 0.0
        for _ in range(5):
            ck, uk, dk = megastep(kcfg, kscfg, oval, kprm, kref, ck, n_sub=4)
            cp, up, dp = megastep_plain(kcfg, kscfg, oval, kprm, kref, cp, n_sub=4)
            torch.cuda.synchronize()
            du = max(du, (uk - up).abs().max().item())
            dx = max(dx, (ck.x - cp.x).abs().max().item())
        log(f"[mega-kin] {name}: max|du|={du:.3e} max|dx|={dx:.3e} done-at kernel "
            f"{dk[4].mean().item():.3f} plain {dp[4].mean().item():.3f}")
        check(du <= tol_u and dx <= tol_x, f"kinematic megastep {name}: beyond ({tol_u}, {tol_x}) of plain")
        mega_err[f"kinematic {name}"] = max(du, dx)
    kc0 = megastep_init(kscen.params, kcfg, oval, kscen.x0)
    megastep(kcfg, scfg, oval, kprm, kref, kc0, n_sub=4)            # warm-up
    kin_dev_ms = kernel_ms(lambda: megastep(kcfg, scfg, oval, kprm, kref, kc0, n_sub=4), 10, "megastep_kernel")
    kin_plain_ms = cuda_time_ms(lambda: megastep_plain(kcfg, scfg, oval, kprm, kref, kc0, n_sub=4), 3)
    log(f"[mega-kin] first step: {kin_dev_ms:.4f} ms kernel (device), {kin_plain_ms:.3f} ms plain ({card})")
    # ---- 5d. the chosen shape on the first nb lanes: a launch holding more
    # clusters than the card runs at once takes a second wave ----
    def first_lanes(args, nb):
        cut = lambda v: v[:nb] if torch.is_tensor(v) and v.dim() >= 1 else v
        pb = args[2]
        pcut = type(pb)(**{f.name: cut(getattr(pb, f.name)) for f in dataclasses.fields(pb)})
        return (*args[:2], pcut, *(cut(t) for t in args[3:]))

    for name, args in fused_args.items():
        wave_ms = {}
        for nb in (2048, 3840, B_MAIN):
            cut_args = first_lanes(args, nb)
            wave_ms[nb] = kernel_ms(lambda: fused_mpc_solve(*cut_args), 5, "fused_kernel")
        log(f"[waves] fused {name}, device ms on the first B lanes: " + ", ".join(
            f"B={nb} ({-(-nb // 128)} clusters) {ms:.4f}" for nb, ms in wave_ms.items()) + f" ({card})")
    for name, (mcfg, mtrack, mprm, mref, mc0) in (("dynamic", (cfg, track, prm, x_ref, c0)),
                                                  ("kinematic", (kcfg, oval, kprm, kref, kc0))):
        wave_ms = {}
        for nb in (2048, 3840, B_MAIN):
            cut_car = type(mc0)(*(t[..., :nb].contiguous() for t in mc0))
            cut_prm = mprm[:, :nb].contiguous()
            wave_ms[nb] = kernel_ms(lambda: megastep(mcfg, scfg, mtrack, cut_prm, mref, cut_car, n_sub=4), 5,
                                    "megastep_kernel")
        log(f"[waves] megastep {name} N={mcfg.N}, device ms of the first step on the first B lanes: "
            + ", ".join(f"B={nb} ({-(-nb // 128)} clusters) {ms:.4f}" for nb, ms in wave_ms.items())
            + f" ({card})")
    if "admm_kernel" in admm and not ab:
        # the solver-only kernel: 16 QPs per block, one block per SM at na=8,
        # N=20 (its shared memory), so 2,112 QPs per wave of the 132 SMs
        qp8, w8, r8 = admm["admm_kernel"][:3]
        wave_ms = {}
        for nb in (1056, 2112, B_MAIN):
            cut = lambda t: t[:nb].contiguous()
            cqp = qp8._replace(dyn=type(qp8.dyn)(*(cut(t) for t in qp8.dyn)),
                               cost=type(qp8.cost)(*(cut(t) for t in qp8.cost)),
                               lb=cut(qp8.lb), ub=cut(qp8.ub), x0=cut(qp8.x0))
            cw, cr = tuple(cut(t) for t in w8), cut(r8)
            wave_ms[nb] = kernel_ms(lambda: admm_kernel_solve(cqp, scfg1, cw, cr), 5, "admm_kernel")
        log(f"[waves] admm na=8 N={N_MAIN}, device ms on the first B QPs: " + ", ".join(
            f"B={nb} ({-(-nb // 16)} blocks of 16) {ms:.4f}" for nb, ms in wave_ms.items()) + f" ({card})")

    # ---- 5e. the racestep at the race presets' horizon, N=12, at path 6's
    # B=4096 and at path 7's B=1 (one real lane and 127 padding lanes that
    # vote "done" in the 128-lane group), 5 noisy steps on the composed
    # protocol's table, at a fixed count (rho_interval=0) and at the path's
    # own solver config. Every lane is held to section 5's bounds (tight at
    # the fixed count, 5e-3 at the path config) one step at a time from
    # plain's carry; each version on its own carry is
    # reported: at N=12 one lane in 4,096 sits at the friction RLS's
    # excitation gate (|dFy/dmu| >= 0.05 fz), which the two versions' 1e-6
    # apart states put on opposite sides, so its mu-hat parts by 0.023 in
    # one step and its controls by ~3e-4 the steps after (NVIDIA H100 80GB
    # HBM3; one step from a common carry agrees to 3e-6 on every lane) ----
    race12 = {}
    rcfg12 = MPCConfig(N=N_RACE, model="dynamic", tire="pacejka")
    scfg6 = SolverConfig(max_iter=40, early_exit=True, check_termination=2)
    scfg7 = SolverConfig(max_iter=60)
    if not ab:
        for nb, path_cfg in ((B_MAIN, scfg6), (1, scfg7)):
            prm_n = rprm[:, :nb].contiguous()
            race12[nb] = {}
            for name, sc in (("fixed, rho_interval=0", path_cfg.replace(early_exit=False, rho_interval=0)),
                             ("path config", path_cfg)):
                ck = cp = racestep_init(p, rcfg12, track, x0r[:nb], 0.85)
                own, step = {}, {}
                for k in range(K_RACE_CMP):
                    a = (rcfg12, sc, track, prm_n, table)
                    nz = noises[k][:, :nb].contiguous()
                    ck, uk, dk, zk = racestep(*a, ck, nz, mu_b[:nb], ekq, ekr)
                    cs, us, ds_, zs = racestep(*a, cp, nz, mu_b[:nb], ekq, ekr)
                    cp, up, dp, zp = racestep_plain(*a, cp, nz, mu_b[:nb], ekq, ekr)
                    torch.cuda.synchronize()
                    for acc, c, u, z in ((own, ck, uk, zk), (step, cs, us, zs)):
                        for key, x, y in (("u0", u, up), ("z", z, zp)) + tuple(
                                (f, getattr(c, f), getattr(cp, f)) for f in ("xg", "ekx", "ekP", "fr", "X_pred")):
                            d = (x - y).abs().reshape(-1, nb).amax(dim=0)
                            acc[key] = torch.maximum(acc[key], d) if key in acc else d
                err_step = {key: v.max().item() for key, v in step.items()}
                err_own = {key: v.max().item() for key, v in own.items()}
                n_conv = int(((ds_[2] > 0.5) & (dp[2] > 0.5)).sum().item())
                log(f"[race-n12] B={nb} N={N_RACE} {name}, max_iter={sc.max_iter}, every lane one step from "
                    f"plain's carry: " + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_step.items())
                    + f"; converged at the last step {n_conv}/{nb}")
                log(f"[race-n12] B={nb} {name}, each version on its own carry: "
                    + " ".join(f"max|d{key}|={v:.3e}" for key, v in err_own.items())
                    + f"; lanes with |du0| > 2e-4: {int((own['u0'] > 2e-4).sum().item())}")
                check(all(bool(torch.isfinite(t).all()) for t in (*ck, uk, dk, zk, *cs, us)),
                      f"racestep N=12 B={nb}: not finite")
                check(n_conv >= 0.9 * nb, f"racestep N=12 B={nb} {name}: only {n_conv} lanes converged")
                # the path configs decide rho switches (and path 6 its exit)
                # at chunk boundaries, where two roundings may part on a
                # ratio at its threshold to two terminated points: 5e-3 there
                bounds_n = tight if name.startswith("fixed") else loose
                for key, tol in bounds_n.items():
                    check(err_step[key] <= tol, f"racestep N=12 B={nb} {name}: |d{key}| {err_step[key]:.3e} beyond "
                          f"{tol} of plain (one step, all lanes)")
                if name == "path config":
                    race12[nb].update(max_abs_err=max(err_step[key] for key in tight),
                                      max_abs_err_own_carries=max(err_own[key] for key in tight))
            c12 = racestep_init(p, rcfg12, track, x0r[:nb], 0.85)
            args12 = (rcfg12, path_cfg, track, prm_n, table, c12, noises[0][:, :nb].contiguous(), mu_b[:nb], ekq, ekr)
            racestep(*args12)                                           # warm-up
            race12[nb]["device_ms"] = kernel_ms(lambda: racestep(*args12), 10, "racestep_kernel")
            race12[nb]["plain_ms"] = cuda_time_ms(lambda: racestep_plain(*args12), 3)
            log(f"[race-n12] B={nb} first step, path config: {race12[nb]['device_ms']:.4f} ms kernel (device), "
                f"{race12[nb]['plain_ms']:.3f} ms plain ({card})")

    if quick:
        log("[quick] kernel checks passed; stopping before the main path")
        return

    # ---- 6. main path 1: the tracker step ----
    wrappers = {"megastep": megastep, "admm": admm_kernel_solve, "racestep": racestep,
                "fused": fused_mpc_solve}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0

    def read_launches(label, expected):
        """Each wrapper's count since the reset; fails unless the path's
        kernels launched as `expected` and every other kernel not at all."""
        got = {k: w.launches for k, w in wrappers.items()}
        log(f"[{label}] launches {got}")
        for k, n in got.items():
            check(n == expected.get(k, 0), f"{label}: {k} launched {n} times, expected {expected.get(k, 0)}")
        return got

    scfg_admm = SolverConfig(max_iter=20, rho_interval=0, backend="admm",
                             polish=False, certify_infeasibility=False)

    def admm_route(pcfg, ptrack, pscen, pref, mcar):
        """K_ADMM_ROUTE steps of mpc_step_batched(backend="admm") + plant_step
        from the megastep's carry: the final state and the converged fraction
        of each step."""
        fb = lambda t: t.movedim(-1, 0)
        xs = fb(mcar.x).contiguous()
        c = MPCCarry(X_pred=fb(mcar.X_pred), U_pred=fb(mcar.U_pred), s=fb(mcar.s),
                     lam=fb(mcar.lam), u_prev=fb(mcar.u_prev), rho=mcar.rho)
        out = []
        for _ in range(K_ADMM_ROUTE):
            u, c, dg = mpc_step_batched(pscen.params, pcfg, scfg_admm, ptrack, xs, pref, c)
            xs = plant_step(pscen.params, pcfg, ptrack, xs, u, n_sub=4)
            out.append(dg.converged.float().mean().item())
        torch.cuda.synchronize()
        return xs, out

    reset_launches()
    car = megastep_init(scen.params, cfg, track, scen.x0)
    s_start = car.x[4].clone()
    conv = torch.empty(K_MAIN, device=dev)
    iters = torch.empty(K_MAIN, device=dev)
    mega_done = torch.empty((K_MAIN, B), device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for k in range(K_MAIN):
        if k == 1:
            start.record()
        car, u0, diag = megastep(cfg, scfg, track, prm, x_ref, car, n_sub=4)
        conv[k] = diag[2].mean()
        iters[k] = diag[4].mean()
        mega_done[k] = diag[4]
    end.record()
    torch.cuda.synchronize()
    mega_ms = start.elapsed_time(end) / (K_MAIN - 1)
    # the same controller through the solver-only kernel, from the final state
    xs, conv_admm = admm_route(cfg, track, scen, x_ref, car)
    launches = read_launches("main", {"megastep": K_MAIN, "admm": K_ADMM_ROUTE})
    # the device's time per step of the megastep path, on 20 more steps
    # from the final carry (the loop's two reductions included)
    held, red, done_row = [car], torch.empty(2, device=dev), torch.empty(B, device=dev)

    def main_step():
        held[0], _, dg = megastep(cfg, scfg, track, prm, x_ref, held[0], n_sub=4)
        red[0], red[1] = dg[2].mean(), dg[4].mean()
        done_row.copy_(dg[4])

    main_dev_ms, main_all_ms = step_device_ms(main_step, 20, "megastep_kernel")

    finite = all(bool(torch.isfinite(t).all()) for t in car) and bool(torch.isfinite(xs).all())
    conv_last = conv[-100:].mean().item()
    done_at = iters.mean().item()
    progress = (car.x[4] - s_start).mean().item()
    log(f"[main] K={K_MAIN} B={B} N={N_MAIN}: {mega_ms:.4f} ms/step "
        f"({B / mega_ms * 1e3:.0f} solves/s) ({card}); device per step: megastep {main_dev_ms:.4f} ms, "
        f"every device operation {main_all_ms:.4f} ms")
    log(f"[main] converged {conv.mean().item():.4f} (last 100: {conv_last:.4f}), mean done-at "
        f"{done_at:.3f}/20 (last 100: {iters[-100:].mean().item():.3f}), mean progress "
        f"{progress:.2f} m, finite={finite}")
    log(f"[main] admm route, {K_ADMM_ROUTE} steps: converged {[round(c, 4) for c in conv_admm]}")
    check(finite, "non-finite state on the main path")
    check(conv_last >= 0.99, f"converged fraction over the last 100 steps {conv_last:.4f} < 0.99")
    check(min(conv_admm) >= 0.99, "admm route did not converge")
    check(progress > 0.0, "the cars did not advance")

    # ---- 7. main path 2: the composed deployment step ----
    run = make_racestep_scan(p_nom, rcfg, scfg, track, table, K_MAIN, mu_b, SIGMA)
    car0 = racestep_init(p, rcfg, track, x0r, 0.85)
    racestep(rcfg, scfg, track, rprm, table, car0, noises[0], mu_b, ekq, ekr)    # warm-up
    torch.cuda.synchronize()
    reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rcar, (Xg, Xf, U, mu_hat, rconv, Z, riters, _) = run(car0, torch.Generator(device=dev).manual_seed(1))
    end.record()
    torch.cuda.synchronize()
    race_launches = read_launches("race-main", {"racestep": K_MAIN})
    race_ms = start.elapsed_time(end) / K_MAIN
    rfinite = all(bool(torch.isfinite(t).all()) for t in rcar) and bool(torch.isfinite(Xf).all())
    rconv_last = rconv[-100:].mean().item()
    rprogress = (Xf[-1, 4] - x0r[:, 4]).mean().item()
    mu_corr = float(np.corrcoef(mu_hat[-1].cpu().numpy(), mu_b.cpu().numpy())[0, 1])
    ey = Xf[:, 5].abs().flatten().cpu().numpy()
    ey_p99, ey_max = float(np.percentile(ey, 99)), float(ey.max())
    cp = racestep_init(p, rcfg, track, x0r, 0.85)
    t0 = time.perf_counter()
    for k in range(3):
        cp, _, _, _ = racestep_plain(rcfg, scfg, track, rprm, table, cp, noises[k], mu_b, ekq, ekr)
    torch.cuda.synchronize()
    race_plain_step_ms = (time.perf_counter() - t0) * 1e3 / 3
    log(f"[race-main] K={K_MAIN} B={B_MAIN} N={N_MAIN}: {race_ms:.4f} ms/step "
        f"({B_MAIN / race_ms * 1e3:.0f} composed solves/s) ({card})")
    log(f"[race-main] converged {rconv.mean().item():.4f} (last 100: {rconv_last:.4f}), mean done-at "
        f"{riters.mean().item():.3f}/20, mu-hat/mu-true corr {mu_corr:.3f}, |e_y| p99 {ey_p99:.4f} "
        f"max {ey_max:.4f}, mean progress {rprogress:.2f} m, finite={rfinite}")
    log(f"[race-main] racestep_plain {race_plain_step_ms:.3f} ms/step over 3 steps ({card})")
    # tools/racebench.py's own window: the runner called 5 more times from
    # the carry it left (fresh noise each), the numbers read on the last
    # 500 steps (steps 2501-3000), the time as the best of the 5 windows
    best_ms, win = float("inf"), None
    for i in range(5):
        start.record()
        rcar, win = run(rcar, torch.Generator(device=dev).manual_seed(2 + i))
        end.record()
        torch.cuda.synchronize()
        best_ms = min(best_ms, start.elapsed_time(end) / K_MAIN)
    wXf, w_mu, w_conv = win[1], win[3], win[4]
    w_corr = float(np.corrcoef(w_mu[-1].cpu().numpy(), mu_b.cpu().numpy())[0, 1])
    w_ey = wXf[:, 5].abs().flatten().cpu().numpy()
    log(f"[race-bench] steps {5 * K_MAIN + 1}-{6 * K_MAIN}: best window {best_ms:.4f} ms/step "
        f"({B_MAIN / best_ms * 1e3:.0f} composed solves/s) ({card}); converged "
        f"{w_conv.mean().item():.4f}, mu-hat/mu-true corr {w_corr:.3f}, |e_y| p99 "
        f"{float(np.percentile(w_ey, 99)):.4f} max {float(w_ey.max()):.4f}")
    check(bool(torch.isfinite(wXf).all()) and w_conv.mean().item() >= 0.99,
          "the composed protocol's last window is not finite or not converged")
    check(rfinite, "non-finite state on the composed path")
    check(rconv_last >= 0.99, f"composed converged fraction over the last 100 steps {rconv_last:.4f} < 0.99")
    check(rprogress > 0.0, "the composed cars did not advance")

    # ---- 7b. main path 5: the composed protocol with per-lane tables,
    # racing three moving opponents whose swept blocks (padded to 8 rows)
    # are refreshed every OBS_SEGMENT steps: race_loop's mega segments. The
    # same run with all-dummy blocks shows the corridor's cost and effect;
    # the quality numbers are reported, the outputs gated on being finite ----
    def obstacle_race(run5, blocks_at, label):
        car = racestep_init(p, rcfg, track, x0r, 0.85)
        gen5 = torch.Generator(device=dev).manual_seed(3)
        segs = []
        reset_launches()
        st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        st.record()
        for i in range(K_OBS_SEGMENTS):
            car, outs = run5(car, gen5, obs["table"], blocks_at(i * OBS_SEGMENT))
            segs.append(outs)
        en.record()
        torch.cuda.synchronize()
        steps = K_OBS_SEGMENTS * OBS_SEGMENT
        out = {"launches": read_launches(label, {"racestep": steps}),
               "ms": st.elapsed_time(en) / steps}
        Xf5 = torch.cat([o[1] for o in segs])                     # (T, 6, B)
        conv5, it5 = torch.cat([o[4] for o in segs]), torch.cat([o[6] for o in segs])
        hit = collision_trace(track, obs["opp"], Xf5.permute(2, 0, 1), rcfg.dt)
        out.update(conv_last=conv5[-100:].mean().item(), done_at=it5.mean().item(), iters=it5,
                   collide=hit.float().mean().item(), lanes_hit=int(hit.any(dim=1).sum().item()),
                   progress=(Xf5[-1, 4] - x0r[:, 4]).mean().item(),
                   finite=all(bool(torch.isfinite(t).all()) for t in car) and bool(torch.isfinite(Xf5).all()))
        log(f"[{label}] K={steps} ({K_OBS_SEGMENTS} segments of {OBS_SEGMENT}) B={B_MAIN} N={N_MAIN}: "
            f"{out['ms']:.4f} ms/step ({B_MAIN / out['ms'] * 1e3:.0f} composed solves/s) ({card}); converged "
            f"(last 100) {out['conv_last']:.4f}, mean done-at {out['done_at']:.3f}/20, lane-steps in collision "
            f"{out['collide']:.5f} ({out['lanes_hit']} lanes ever), mean progress {out['progress']:.2f} m, "
            f"finite={out['finite']}")
        check(out["finite"], f"{label}: non-finite state")
        return out

    obs_run = obs_free = None
    if obs is not None:
        run5 = make_racestep_scan(p_nom, rcfg, scfg, track, None, OBS_SEGMENT, mu_b, SIGMA, table_arg=True,
                                  obstacles_arg=True)
        obs_run = obstacle_race(run5, lambda t: pad_blocks(obs["obs_fn"](t), 8), "race-obs")
        obs_free = obstacle_race(run5, lambda t: pad_blocks(None, 8), "race-obs-dummy-blocks")
        log(f"[race-obs] the corridor: {obs_run['ms'] - obs_free['ms']:+.4f} ms/step, lane-steps in collision "
            f"{obs_free['collide']:.5f} -> {obs_run['collide']:.5f}, converged (last 100) "
            f"{obs_free['conv_last']:.4f} -> {obs_run['conv_last']:.4f}, mean done-at "
            f"{obs_free['done_at']:.3f} -> {obs_run['done_at']:.3f}")

    # ---- 8. main path 3: bench.py's fused protocol ----
    def fused_run(fcfg, ftrack, fscen, fref, label):
        """K_MAIN steps of mpc_step_batched(backend="fused") + plant_step."""
        reset_launches()
        fcar, fx = mpc_init(fscen.params, fcfg, ftrack, fscen.x0), fscen.x0
        s_i, ey_i = model_s_ey(fcfg.model)
        fconv = torch.empty(K_MAIN, device=dev)
        fiters = torch.empty(K_MAIN, device=dev)
        ey_max = torch.zeros((), device=dev)
        st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for k in range(K_MAIN):
            if k == 1:
                st.record()
            u, fcar, d = mpc_step_batched(fscen.params, fcfg, fused_fixed, ftrack, fx, fref, fcar)
            fx = plant_step(fscen.params, fcfg, ftrack, fx, u, n_sub=4)
            fconv[k] = d.converged.float().mean()
            fiters[k] = d.iters.float().mean()
            ey_max = torch.maximum(ey_max, fx[:, ey_i].abs().max())
        en.record()
        torch.cuda.synchronize()
        out = dict(ms=st.elapsed_time(en) / (K_MAIN - 1), conv_last=fconv[-100:].mean().item(),
                   done_at=fiters.mean().item(), ey_max=ey_max.item(),
                   progress=(fx[:, s_i] - fscen.x0[:, s_i]).mean().item(),
                   finite=bool(torch.isfinite(fx).all()),
                   launches=read_launches(label, {"fused": K_MAIN}))
        log(f"[{label}] K={K_MAIN} B={fscen.batch} N={fcfg.N} fused path: {out['ms']:.4f} ms/step "
            f"({fscen.batch / out['ms'] * 1e3:.0f} solves/s) ({card}); converged (last 100) "
            f"{out['conv_last']:.4f}, mean done-at {out['done_at']:.3f}/20, |e_y| max "
            f"{out['ey_max']:.4f}, mean progress {out['progress']:.2f} m, finite={out['finite']}")
        check(out["finite"], f"{label}: non-finite state on the fused path")
        check(out["conv_last"] >= 0.99, f"{label}: converged (last 100) {out['conv_last']:.4f} < 0.99")
        check(out["progress"] > 0.0, f"{label}: the cars did not advance")
        return out

    bscen = make_scenario_grid(p, cfg, n_ey=64, n_mu=B_MAIN // 64, vx0=1.5)
    check(bscen.x0.is_cuda, "make_scenario_grid() did not default to the card")
    fused_bench = fused_run(cfg, racetrack(), bscen, constant_refs(cfg, 1.8), "fused-main")

    # ---- 9. main path 4: BASELINE config 1 batched, fused path then megastep ----
    fused_cfg1 = fused_run(kcfg, oval, kscen, kref, "config1-fused")
    check(fused_cfg1["ey_max"] < 0.4, f"config 1 fused: |e_y| max {fused_cfg1['ey_max']:.4f} >= 0.4")
    reset_launches()
    kcar = megastep_init(kscen.params, kcfg, oval, kscen.x0)
    kconv = torch.empty(K_MAIN, device=dev)
    kiters = torch.empty(K_MAIN, device=dev)
    kin_done = torch.empty((K_MAIN, B_MAIN), device=dev)
    k_ey = torch.zeros((), device=dev)
    for k in range(K_MAIN):
        if k == 1:
            start.record()
        kcar, _, kd = megastep(kcfg, scfg, oval, kprm, kref, kcar, n_sub=4)
        kconv[k] = kd[2].mean()
        kiters[k] = kd[4].mean()
        kin_done[k] = kd[4]
        k_ey = torch.maximum(k_ey, kcar.x[3].abs().max())
    end.record()
    torch.cuda.synchronize()
    kin_ms = start.elapsed_time(end) / (K_MAIN - 1)
    # then the same controller through the solver-only kernel (na=6), which
    # older trees (--ab) do not take
    kxs, kconv_admm = admm_route(kcfg, oval, kscen, kref, kcar) if not ab else (None, None)
    kin_launches = read_launches("config1-mega", {"megastep": K_MAIN, "admm": 0 if ab else K_ADMM_ROUTE})
    kin_conv = kconv[-100:].mean().item()
    kin_prog = (kcar.x[2] - kscen.x0[:, 2]).mean().item()
    log(f"[config1-mega] K={K_MAIN} B={B_MAIN} N=10 kinematic megastep: {kin_ms:.4f} ms/step "
        f"({B_MAIN / kin_ms * 1e3:.0f} solves/s) ({card}); converged (last 100) {kin_conv:.4f}, "
        f"mean done-at {kiters.mean().item():.3f}/20, |e_y| max {k_ey.item():.4f}, mean progress "
        f"{kin_prog:.2f} m")
    check(bool(torch.isfinite(kcar.x).all()), "config 1 megastep: non-finite state")
    check(kin_conv >= 0.99, f"config 1 megastep: converged (last 100) {kin_conv:.4f} < 0.99")
    check(k_ey.item() < 0.4, f"config 1 megastep: |e_y| max {k_ey.item():.4f} >= 0.4")
    check(kin_prog > 0.0, "config 1 megastep: the cars did not advance")
    if not ab:
        log(f"[config1-mega] admm route, {K_ADMM_ROUTE} steps: converged {[round(c, 4) for c in kconv_admm]}")
        check(bool(torch.isfinite(kxs).all()) and min(kconv_admm) >= 0.99,
              "config 1 admm route did not converge")

    # ---- 10. the planner: plan_mpp at the race presets' MPPConfig on the
    # card (eager, then from its CUDA graphs: the first graphed plan captures
    # them) against the same plan by the port on the CPU; then BASELINE
    # config 3's default MPPConfig (H=512, n_sqp=4) ----
    plan = sweep = race7 = None
    if not ab:
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPPConfig
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import mega_race_sweep, race_loop
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import race as race_mod
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import plan_mpp

        def wall_ms(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        pcfg = MPPConfig.for_model("dynamic", H=256, n_sqp=2)
        p_lo = p.replace(mu=0.5)
        reset_launches()
        (tab_e, d_e), plan_eager_ms = wall_ms(lambda: plan_mpp(p_lo, pcfg, track, graphed=False))
        (_, _), plan_capture_ms = wall_ms(lambda: plan_mpp(p_lo, pcfg, track))
        (tab_g, d_g), plan_graph_ms = wall_ms(lambda: plan_mpp(p_lo, pcfg, track))
        read_launches("plan", {})
        t0 = time.perf_counter()
        tab_c, d_c = plan_mpp(p_lo, pcfg, racetrack(device="cpu"))
        plan_cpu_ms = (time.perf_counter() - t0) * 1e3
        dtab = {k: max((getattr(tab_g, k).cpu() - getattr(tab_c, k)).abs().max().item(),
                       (getattr(tab_e, k).cpu() - getattr(tab_c, k)).abs().max().item()) for k in ("vx", "ey", "delta")}
        dge = max((getattr(tab_g, k) - getattr(tab_e, k)).abs().max().item() for k in ("vx", "ey", "delta"))
        prog_rel = abs(float(d_g.progress) - float(d_c.progress)) / abs(float(d_c.progress))
        plan = {"eager_ms": plan_eager_ms, "capture_ms": plan_capture_ms, "graph_ms": plan_graph_ms}
        log(f"[plan] H={pcfg.H} n_sqp={pcfg.n_sqp} racetrack mu=0.5: {plan_eager_ms:.1f} ms/plan eager, {plan_capture_ms:.1f} ms "
            f"first graphed plan (captures), {plan_graph_ms:.1f} ms/plan graphed ({card}); {plan_cpu_ms:.1f} ms on the "
            f"host CPU")
        log(f"[plan] card vs CPU: max|dvx|={dtab['vx']:.3e} max|dey|={dtab['ey']:.3e} max|ddelta|={dtab['delta']:.3e} "
            f"(tolerance 5e-3); graphed vs eager {dge:.3e}; converged card {d_g.converged.tolist()} cpu "
            f"{d_c.converged.tolist()}, iters card {d_g.iters.tolist()} cpu {d_c.iters.tolist()}; progress "
            f"{float(d_g.progress):.4f} vs {float(d_c.progress):.4f} m, lap_time {float(d_g.lap_time):.4f} vs "
            f"{float(d_c.lap_time):.4f} s")
        check(all(bool(torch.isfinite(getattr(tab_g, k)).all()) for k in ("vx", "ey", "delta")), "[plan] not finite")
        check(max(dtab.values()) <= 5e-3, f"[plan] the card's table is {max(dtab.values()):.3e} from the CPU's")
        check(dge <= 5e-3, f"[plan] the graphed plan is {dge:.3e} from the eager one")
        check(d_g.converged.tolist() == d_c.converged.tolist(), "[plan] convergence differs from the CPU's")
        check(prog_rel <= 1e-3, f"[plan] progress {prog_rel:.3e} (relative) from the CPU's")
        pcfg3 = MPPConfig()
        (_, _), plan3_capture_ms = wall_ms(lambda: plan_mpp(p, pcfg3, track))
        (tab3, d3), plan3_ms = wall_ms(lambda: plan_mpp(p, pcfg3, track))
        plan.update(h512_capture_ms=plan3_capture_ms, h512_ms=plan3_ms)
        log(f"[plan] H={pcfg3.H} n_sqp={pcfg3.n_sqp} (BASELINE config 3) mu=1.0: {plan3_capture_ms:.1f} ms first (captures), "
            f"{plan3_ms:.1f} ms/plan graphed ({card}); converged {d3.converged.tolist()}, iters {d3.iters.tolist()}, "
            f"lap_time {float(d3.lap_time):.4f} s, progress {float(d3.progress):.4f} m")
        check(bool(torch.isfinite(tab3.vx).all()) and float(d3.progress) > float(track.length),
              "[plan] the H=512 plan is not finite or covers less than a lap")

        # ---- 11. main path 6: race_sweep's protocol at full width on the
        # [plan] table (planned at mu_lo = 0.5) ----
        mu6 = torch.linspace(0.5, 1.2, B_MAIN, device=dev)
        x06 = torch.zeros((B_MAIN, 6), device=dev)
        x06[:, 0] = 1.0
        # each step's done-at per lane, for the bound below: the wrapper calls
        # its launcher through the module, so a recorder there sees every
        # launch (and the wrapper still counts it)
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import racestep_kernel as rk_mod

        done6, launch_cuda = [], rk_mod._racestep_cuda

        def recording_launch(*a, **k):
            out = launch_cuda(*a, **k)
            done6.append(out[2][4])
            return out

        reset_launches()
        st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        rk_mod._racestep_cuda = recording_launch
        try:
            st.record()
            log6 = mega_race_sweep(p, rcfg12, scfg6, track, tab_g, x06, T=T_SWEEP, mu_true_b=mu6, mu0=0.85,
                                   noise_sigma=SIGMA, seed=6)
            en.record()
            torch.cuda.synchronize()
        finally:
            rk_mod._racestep_cuda = launch_cuda
        sweep = {"launches": read_launches("race-sweep", {"racestep": T_SWEEP}),
                 "ms": st.elapsed_time(en) / T_SWEEP}
        mu_fin = log6.mu_hat[:, -1].cpu().numpy()
        err6 = np.abs(mu_fin - mu6.cpu().numpy())
        ey6 = log6.Xf[..., 5].abs().flatten().cpu().numpy()
        sweep.update(corr=float(np.corrcoef(mu_fin, mu6.cpu().numpy())[0, 1]), mu_err_median=float(np.median(err6)),
                     mu_err_p90=float(np.percentile(err6, 90)), converged=log6.converged.mean().item(),
                     ey_p99=float(np.percentile(ey6, 99)), ey_max=float(ey6.max()),
                     finite=all(bool(torch.isfinite(t).all()) for t in log6))
        log(f"[race-sweep] B={B_MAIN} T={T_SWEEP} N={N_RACE}: {sweep['ms']:.4f} ms/composed step "
            f"({B_MAIN / sweep['ms'] * 1e3:.0f} composed solves/s) ({card}); mu-hat/mu-true corr "
            f"{sweep['corr']:.4f} (TPU run {TPU_SWEEP['corr']}), |mu err| median {sweep['mu_err_median']:.4f} p90 "
            f"{sweep['mu_err_p90']:.4f}, converged {sweep['converged']:.4f} (TPU run {TPU_SWEEP['converged']}), "
            f"|e_y| p99 {sweep['ey_p99']:.4f} (TPU run {TPU_SWEEP['ey_p99']}) max {sweep['ey_max']:.4f}, "
            f"finite={sweep['finite']}")
        check(sweep["finite"], "[race-sweep] non-finite output")
        check(sweep["converged"] >= 0.95, f"[race-sweep] converged {sweep['converged']:.4f} < 0.95")

        # ---- 12. main path 7: the flagship race preset, race_loop on the
        # racestep at B=1 with the planner replanning every 60 steps; the wall
        # split between plans and segments by timing race_loop's planner
        # calls; then 120 steps of the module composition (no kernel) ----
        plan_wall = [0.0]

        def timed_plan(*a, **k):
            out, ms = wall_ms(lambda: plan_mpp(*a, **k))
            plan_wall[0] += ms
            return out

        race_mod.plan_mpp = timed_plan
        try:
            x07 = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], device=dev)
            reset_launches()
            log7, wall7 = wall_ms(lambda: race_loop(p, rcfg12, scfg7, pcfg, track, x07, T=T_RACE, mu_true=0.6,
                                                    mu0=1.0, replan_every=REPLAN_EVERY, noise_sigma=SIGMA,
                                                    seed=7, backend="mega"))
            race7 = {"launches": read_launches("race-loop", {"racestep": T_RACE}), "wall_ms": wall7,
                     "plan_ms": plan_wall[0]}
            plan_wall[0] = 0.0
            reset_launches()
            log7p, wall7p = wall_ms(lambda: race_loop(p, rcfg12, scfg7, pcfg, track, x07, T=T_RACE_PLAIN,
                                                      mu_true=0.6, mu0=1.0, replan_every=REPLAN_EVERY,
                                                      noise_sigma=SIGMA, seed=7, backend="plain"))
            read_launches("race-loop-plain", {})
            race7["plain_ms"] = (wall7p - plan_wall[0]) / T_RACE_PLAIN
        finally:
            race_mod.plan_mpp = plan_mpp
        race7["ms"] = (race7["wall_ms"] - race7["plan_ms"]) / T_RACE
        lap_steps = log7.lap_steps.tolist()
        lap_s = [round((b - a) * rcfg12.dt, 3) for a, b in zip([0] + lap_steps[:-1], lap_steps)]
        ey7 = log7.Xf[:, 5]
        race7.update(mu_hat=log7.mu_hat[-1].item(), laps=len(lap_steps), lap_s=lap_s,
                     ey_rms=ey7.pow(2).mean().sqrt().item(), ey_max=ey7.abs().max().item(),
                     converged=log7.converged.mean().item(), updates=log7.replan_steps.numel() - 1,
                     finite=all(bool(torch.isfinite(getattr(log7, f)).all()) for f in ("Xg", "Xf", "U", "mu_hat")))
        log(f"[race-loop] T={T_RACE} B=1 N={N_RACE} mega: mu-hat final {race7['mu_hat']:.4f} (TPU run "
            f"{TPU_RACE['mu_hat']}), laps {race7['laps']}, lap times {race7['lap_s']} s (TPU run {TPU_RACE['lap_s']} s), "
            f"e_y rms {race7['ey_rms']:.4f} (TPU run {TPU_RACE['ey_rms']}) max {race7['ey_max']:.4f}, converged "
            f"{race7['converged']:.4f} (TPU run {TPU_RACE['converged']}), table updates {race7['updates']}, "
            f"finite={race7['finite']}")
        log(f"[race-loop] wall {race7['wall_ms']:.1f} ms: plans {race7['plan_ms']:.1f} ms "
            f"({race7['updates'] + 1} plans), segments {race7['wall_ms'] - race7['plan_ms']:.1f} ms = "
            f"{race7['ms']:.4f} ms/step ({card})")
        log(f"[race-loop] plain backend, {T_RACE_PLAIN} steps: {race7['plain_ms']:.3f} ms/step of segments "
            f"(wall {wall7p:.1f} ms, plans {plan_wall[0]:.1f} ms) ({card}); mu-hat {log7p.mu_hat[-1].item():.4f}, "
            f"converged {log7p.converged.float().mean().item():.4f}")
        check(race7["finite"], "[race-loop] non-finite output")
        check(race7["laps"] >= 1, "[race-loop] completed no lap")
        check(race7["ey_max"] < 0.45, f"[race-loop] |e_y| max {race7['ey_max']:.4f} >= 0.45")
        check(all(bool(torch.isfinite(getattr(log7p, f)).all()) for f in ("Xg", "Xf", "U", "mu_hat")),
              "[race-loop] the plain backend's output is not finite")

    # ---- bounds: this run's shapes, data and iteration counts ----
    # the admm kernel's stage matrices are its inputs: their patterns are
    # read from this run's QPs (A = Aa, B = Ba there)
    pat_of = lambda t: (t != 0).reshape((-1,) + tuple(t.shape[-2:])).any(dim=0).cpu().numpy()

    def admm_per_lane(qp):
        """(operations, bytes) per QP of the solver-only kernel."""
        qD = np.concatenate([qp.Dx.cpu().numpy() != 0, qp.Du.cpu().numpy() != 0], axis=1)
        qA, qB = pat_of(qp.dyn.A), pat_of(qp.dyn.B)
        qc = (qp.dyn.c != 0).reshape(-1, qp.dyn.c.shape[-1]).any(dim=0).cpu().numpy()
        S_qp = Structure(qA, qB, qA, qB, qD, int(torch.isfinite(qp.soft).sum().item()))
        N_qp, na = qp.dyn.A.shape[1], qp.Dx.shape[1]
        return (N_qp * factor_ops(qA, qB, qc) + scfg1.max_iter * iteration_ops(S_qp, N_qp, c=qc),
                admm_bytes(N_qp, na))

    S_dyn, S_kin, S_race = (model_structure(p, c, scfg) for c in (cfg, kcfg, rcfg))
    win = min(2 * _win_cells(track, 3.0) + 1, track.n_cells)
    it = {"admm_kernel": scfg1.max_iter, "admm_kernel_kinematic": scfg1.max_iter,
          "megastep_kernel": executed_iters(mega_done),
          "megastep_kernel_kinematic": executed_iters(kin_done),
          "racestep_kernel": executed_iters(riters), "fused_kernel": fused_fixed.max_iter,
          "fused_kernel_kinematic": fused_fixed.max_iter}
    per_lane = {   # (operations, bytes) per lane; the shared tables per launch below
        **{name: admm_per_lane(rec[0]) for name, rec in admm.items()},
        "megastep_kernel": (core_ops(S_dyn, cfg.tire, N_MAIN, it["megastep_kernel"])
                            + plant_ops(S_dyn, cfg.tire, 4), mega_bytes(6, N_MAIN)),
        "megastep_kernel_kinematic": (core_ops(S_kin, kcfg.tire, kcfg.N, it["megastep_kernel_kinematic"])
                                      + plant_ops(S_kin, kcfg.tire, 4), mega_bytes(4, kcfg.N)),
        "racestep_kernel": (race_ops(S_race, N_MAIN, it["racestep_kernel"], 4, 10, win, gate=False),
                            race_bytes(N_MAIN)),
        "fused_kernel": (fused_ops(S_dyn, cfg.tire, N_MAIN, it["fused_kernel"]), fused_bytes(6, N_MAIN)),
        "fused_kernel_kinematic": (fused_ops(S_kin, kcfg.tire, kcfg.N, it["fused_kernel_kinematic"]),
                                   fused_bytes(4, kcfg.N)),
    }
    # shared per launch: the curvature and pose tables, the selector rows
    shared = {**{name: 4 * (NC * (rec[0].Dx.shape[1] + NU) + NC) for name, rec in admm.items()},
              "megastep_kernel": 4 * track.n_cells, "megastep_kernel_kinematic": 4 * oval.n_cells,
              "racestep_kernel": 4 * (4 * track.n_cells + 3 * table.vx.shape[0] + 16)}
    if obs_run is not None:
        # main path 5: the corridor operand and each lane's own table nodes
        it["racestep_kernel+eyb+per-lane"] = executed_iters(obs_run["iters"])
        per_lane["racestep_kernel+eyb+per-lane"] = (
            race_ops(S_race, N_MAIN, it["racestep_kernel+eyb+per-lane"], 4, 10, win, gate=False),
            race_bytes(N_MAIN, eyb=True, per_lane=True))
        shared["racestep_kernel+eyb+per-lane"] = 4 * (4 * track.n_cells + 16)
        # the megastep with a corridor, at main path 1's executed iterations
        it["megastep_kernel+eyb"] = it["megastep_kernel"]
        per_lane["megastep_kernel+eyb"] = (per_lane["megastep_kernel"][0], mega_bytes(6, N_MAIN, eyb=True))
        shared["megastep_kernel+eyb"] = shared["megastep_kernel"]
    lanes = {}
    if sweep is not None:
        # paths 6 and 7: the racestep at N=12 on a planned table, B=4096 and B=1
        S_race12 = model_structure(p, rcfg12, scfg6)
        it["racestep_kernel n12"] = executed_iters(torch.stack(done6))
        per_lane["racestep_kernel n12"] = (race_ops(S_race12, N_RACE, it["racestep_kernel n12"], 4, 10, win, gate=False),
                                           race_bytes(N_RACE))
        shared["racestep_kernel n12"] = 4 * (4 * track.n_cells + 3 * tab_g.vx.shape[0] + 16)
        # B=1: path 7's one car
        it["racestep_kernel n12 B=1"] = scfg7.max_iter      # no early exit: every launch runs them all
        per_lane["racestep_kernel n12 B=1"] = (race_ops(S_race12, N_RACE, it["racestep_kernel n12 B=1"], 4, 10, win,
                                                        gate=False), race_bytes(N_RACE))
        shared["racestep_kernel n12 B=1"] = shared["racestep_kernel n12"]
        lanes["racestep_kernel n12 B=1"] = 1
    bounds = {k: bound(lanes.get(k, B_MAIN) * o, lanes.get(k, B_MAIN) * b + shared.get(k, 0))
              for k, (o, b) in per_lane.items()}
    log("[bound] per launch on the H100 at B=4096 unless named (67 TFLOP/s f32, 3.35 TB/s): " + "; ".join(
        f"{k} {bounds[k][0]:.4f} ms ({bounds[k][1]}: {per_lane[k][0]:,.0f} operations and "
        f"{per_lane[k][1]:,} B per lane at {it[k]:.2f} executed iterations)" for k in per_lane))

    src = f"{PKG}/ops/csrc"
    ref_pkg = "autonomous_racing_lpv_mpp_mpc_tpu/ops"
    gcore = f"{src}/group_core.cuh"
    # (name, source, TPU kernel, launches on its main path, max |kernel - plain|,
    # ms on the card (CUDA events), device ms (profiler), plain ms); one record
    # per instantiation
    admm_launches = {"admm_kernel": launches["admm"], "admm_kernel_kinematic": kin_launches["admm"]}
    records = [
        (name, f"{src}/admm_kernel.cu + {gcore}", "admm_kernel.py:342", admm_launches[name], *rec[3:])
        for name, rec in admm.items()
    ] + [
        ("megastep_kernel", f"{src}/megastep_kernel.cu + {gcore}", "megastep_kernel.py:1081",
         launches["megastep"], mega_err["fixed"], mega_ms, mega_dev_ms, mega_plain_ms),
        ("megastep_kernel_kinematic", f"{src}/megastep_kernel.cu + {gcore}", "megastep_kernel.py:1081",
         kin_launches["megastep"], mega_err["kinematic fixed"], kin_ms, kin_dev_ms, kin_plain_ms),
        ("racestep_kernel", f"{src}/racestep_kernel.cu + {gcore}", "racestep_kernel.py:831",
         race_launches["racestep"], race_err["fixed"], race_ms, race_dev_ms, race_plain_step_ms),
        ("fused_kernel", f"{src}/fused_kernel.cu + {gcore}", "fused_kernel.py:429",
         fused_bench["launches"]["fused"], fused_err["dynamic", "fixed"], *fused_iso["dynamic"]),
        ("fused_kernel_kinematic", f"{src}/fused_kernel.cu + {gcore}", "fused_kernel.py:429",
         fused_cfg1["launches"]["fused"], fused_err["kinematic", "fixed"], *fused_iso["kinematic"]),
    ]
    # no single PyTorch call computes a batched Riccati / ADMM solve: library_ms is null
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": f"{ref_pkg}/{tpu}", "launches": n,
         "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, source, tpu, n, err, ms, dev_ms, plain in records]
    if obs_run is not None:
        # the racestep runs main paths 2 and 5: its launches are both paths';
        # ms, device_ms and the bound above are main path 2's, path 5's below
        race_rec = next(k for k in kernels if k["name"] == "racestep_kernel")
        race_rec["launches"] += obs_run["launches"]["racestep"]
        b5 = bounds["racestep_kernel+eyb+per-lane"]
        race_rec["paths"] = {
            "race-main": {"launches": race_launches["racestep"], "ms": race_ms, "device_ms": race_dev_ms},
            "race-obs": {"launches": obs_run["launches"]["racestep"], "ms": obs_run["ms"],
                         "device_ms": obs["dev_ms"]["per-lane+eyb"], "max_abs_err": obs["err"],
                         "max_abs_err_own_carries": obs["err_own_carries"],
                         "plain_ms": obs["plain_ms"], "bound_ms": b5[0], "bound_by": b5[1]}}
        if sweep is not None:
            # paths 6 and 7 (N=12): launches, ms per step (CUDA events over
            # path 6; path 7's segments' wall time per step), device ms of one
            # launch at the path's width, the kernel-vs-plain check at N=12
            b6, b7 = bounds["racestep_kernel n12"], bounds["racestep_kernel n12 B=1"]
            race_rec["launches"] += sweep["launches"]["racestep"] + race7["launches"]["racestep"]
            race_rec["paths"]["race-sweep"] = {
                "launches": sweep["launches"]["racestep"], "ms": sweep["ms"], "device_ms": race12[B_MAIN]["device_ms"],
                "max_abs_err": race12[B_MAIN]["max_abs_err"],
                "max_abs_err_own_carries": race12[B_MAIN]["max_abs_err_own_carries"],
                "plain_ms": race12[B_MAIN]["plain_ms"],
                "bound_ms": b6[0], "bound_by": b6[1]}
            race_rec["paths"]["race-loop"] = {
                "launches": race7["launches"]["racestep"], "ms": race7["ms"], "device_ms": race12[1]["device_ms"],
                "max_abs_err": race12[1]["max_abs_err"],
                "max_abs_err_own_carries": race12[1]["max_abs_err_own_carries"], "plain_ms": race12[1]["plain_ms"],
                "bound_ms": b7[0], "bound_by": b7[1]}
        mega_rec = next(k for k in kernels if k["name"] == "megastep_kernel")
        mega_rec["eyb"] = {"max_abs_err": mega_eyb["fixed"], "device_ms": mega_eyb["dev_ms"],
                           "box_device_ms": mega_eyb["box_dev_ms"],
                           "bound_ms": bounds["megastep_kernel+eyb"][0]}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
