#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ops/csrc`` with nvcc, holds
each against its plain PyTorch version on the card (the megastep and the
racestep also with an obstacle corridor, the racestep with per-lane
reference tables and at the race presets' N=12 for B=4096 and B=1, the
megastep as the lap learner runs it: N=10, Pacejka, per-lane references),
then drives ten main paths, the planner, the cached megastep, the
experiment command line, the parallel layer and the oracle rungs:

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
  120 steps of the same program with ``backend="plain"`` (no kernel);
- the ``race`` preset in learn mode (path 7b): ``race_loop(backend="mega")``
  on the oval, T=900, mu_true=0.6, mu0=1.0, the ``initial_table(ds=0.05,
  vx0=1.0)`` seed (no plan) refined every 2 segments of 60 steps by the
  lap learner (``LapLearnConfig(gain=0.7, dv_max=0.8)``) at the live
  mu-hat, path 7's tracker and sensor noise: one racestep launch per step
  at B=1;
- ``race_learn`` (path 8, ``bench/presets.py:562-630`` at the TPU run's
  size): ``mega_race_learn``, B=1024 cars on the racetrack, 10 windows of
  300 steps, N=12 Pacejka, ``SolverConfig(max_iter=50, rho_interval=0,
  early_exit=True, check_termination=2)``, plant friction
  ``linspace(0.45, 1.2)``, seed mu0=0.825, s spread over the lap, the
  sensor noise above, each car on its own table from
  ``initial_table(ds=0.05, vx0=1.2)``, refined between windows at its own
  mu-hat (``LapLearnConfig(gain=0.5, dv_max=0.5)``): one racestep launch
  per step;
- lap learning at 4,096 cars (path 9): ``batched_lap_learning(backend=
  "mega")`` on ``oval_track(ds=0.05)``, 6 laps of 420 steps from vx 1.0 at
  s=0, friction ``linspace(0.5, 1.2)``, ``MPCConfig(N=10,
  tire="pacejka")`` and a Pacejka plant, ``SolverConfig(max_iter=50,
  early_exit=True, check_termination=2)``, ``LapLearnConfig(gain=0.7,
  dv_max=0.8, a_lat_frac=0.78)``: one megastep launch per step with
  per-lane references sampled on the host from per-lane tables;
- ``[mega-cache]``: the first path with the megastep's discretization
  cache (``cache_build`` at its defaults, tolerance 0.3 and age 8), K=500
  launches of the cached instantiation: its first step bitwise the
  uncached kernel's, the kernel one step (fixed count) from plain's carry
  and cache at six points of the run and on BASELINE config 1's kinematic
  grid (u 2e-4, x 5e-4, equal ages: the same branch in every group), the
  reuse share, |du| against the uncached kernel forked from the same
  carry, and the device time split into forced rebuilds and shifts;
- ``[cli]``: the experiment command line in-process (``cli.main``): ``list``
  names the JAX package's 12 presets, and the presets run on their routes
  on the card (config1, config1_planner, config2, config3, adaptive and
  learn on the fused kernel, config4 fused and on the solver-only kernel,
  latency fused, race_sweep, race_learn and ``race`` (T=240) on the
  racestep, ``race`` (T=30) and config1 (T=30) on the plain route), each
  gated on its healthy numbers and on its kernels' launches;
- the parallel layer, on a mesh of one NCCL rank: ``[config5]`` BASELINE
  config 5 at its own scale, 131,072 scenarios (``make_scenario_grid(64,
  2048, vx0=1.5)``, N=14, the racetrack, a Pacejka plant, T=30, the CLI's
  ``SolverConfig(max_iter=60)``) through ``sharded_closed_loop`` on the
  fused route and through ``sharded_mega_loop``, lanes 0-4095 bitwise an
  unsharded run of the same lanes (the megastep's every lane and metrics
  also bitwise an unsharded run of all lanes), the fused kernel and the
  megastep each held against its plain version one step from the sweep's
  own carry at 131,072 lanes, the peak device memory, and the
  ``config5`` preset through the command line; ``[sharded]``
  ``sharded_race_sweep`` (path 2's protocol, T=100) against
  ``mega_race_sweep``, ``sharded_solve_step`` on the solver-only kernel
  against ``mpc_step_batched`` and ``horizon_sharded_solve`` (one horizon
  rank, N=20) against ``admm_solve``; ``[ckpt]`` ``checkpointed_sweep``
  (B=4096, T=100, chunks of 50, the fused protocol) killed after its first
  chunk and resumed, against an uninterrupted run, bit for bit;
  ``[global]`` ``closed_loop_global`` (B=4096 cars on the oval, the fused
  route, the EKF, sensor noise, T=250) gated on a lap, |e_y| < 0.2 and
  converged > 0.9 on every lane, the fused kernel at its N=16 held against
  its plain version from the loop's carry halfway; ``[mhe]`` ``mhe_step`` over 4,096 noisy
  trajectories (W=8, 2 Gauss-Newton passes, T=90) gated on beating 0.6 x
  the sensor's rmse, lanes 0-15 again on the CPU;
- the last slice: ``[pipelined]`` tests/test_planner.py:147-185's scenario
  at its size (the oval, ``MPCConfig(N=16)``, the tracker on the fused
  kernel, ``MPPConfig(H=192, n_sqp=2)``, T=240, a replan every 60 steps,
  the block [4, 5, -0.4, 0.1] from step 60) through the serial
  ``replanning_loop`` (plans and segments timed) and then
  ``pipelined_replanning_loop`` (the planner on a second stream from a
  second host thread): the JAX test's checks on both, replan steps, the
  first segment bitwise equal, the boundary predictor on the card against
  the CPU, the overlap of the planner stream's kernels with the tracker's
  from a ``trace_to`` trace of a third run (from the plan for segment 2's
  issue over 30 tracker steps), the fused kernel
  at B=1, N=16 against plain from the loop's carry at step 120, at the
  gated runs' 100 iterations and at the JAX test's 60;
  ``[realtime]`` the real-time loop over the shm bridge against a car in
  a child process (``tests/_torch_car_worker.py``, the port on the CPU):
  noise-free in lockstep on the racetrack with cell 3's tracker at B=1
  (held within 1e-3 of the in-process ``closed_loop`` on the card), and
  the noisy, glitchy car on the oval with the EKF (replayed from a CUDA
  graph) in the chain, 300 frames each: frame counts, the median solve
  under 1/30 s, the EKF beating the raw frames 2x, the fused kernel at
  each N against plain from the loop's carry; ``[utils]`` ``timed``
  within 20% of CUDA events on one megastep, a ``trace_to`` trace naming
  the megastep kernel, the NaN mode
  raising on a seeded NaN and not on a megastep step, and
  ``checked_closed_loop`` flagging e_y = 25;
- ``[oracle]``, beside cells 1-3: each CUDA kernel held against the port's
  f64 OSQP oracle (``oracle/``, numpy on the host, in worker processes) on
  the QP that ``mpc_prepare`` assembles from the carry the kernel steps
  from: the megastep at B=1 over one oval lap (N=12, the JAX package's
  tests/test_headline_oracle.py) and one racetrack lap (N=20, a sinusoidal
  reference table), every 5th step, under 5e-5; the megastep on cell 1,
  the racestep on cell 2, the fused kernel on cell 3 and the solver-only
  kernel on cell 1's admm steps, 32 lanes every 50th step (every admm
  step), under 5e-4 on the lane-checks converged on both sides (at least
  90% of them); 16 QPs also by the native C++ core.

The new paths build their tracks, grids and references without naming a
device: the port's default device is the card. The ``kernels`` line has
one record per kernel instantiation (the megastep, the fused kernel and the
solver-only kernel each for the dynamic and the kinematic model, the
racestep, and the megastep with the discretization cache), each with its
launches on all of its main paths (the megastep: paths 1, 4 and 9 and
``[config5]``; the cached megastep: ``[mega-cache]``; the racestep: paths
2, 5, 6, 7, 7b and 8 and ``[sharded]``; the fused kernel: paths 3 and 4,
``[config5]``, ``[ckpt]``, ``[global]``, ``[pipelined]`` and
``[realtime]``; the solver-only kernel: the
admm steps and ``[sharded]``) and its bound
on the H100: the larger of the operations the algorithm needs over 67
TFLOP/s f32 and its bytes over 3.35 TB/s, counted at this run's shapes and
executed iterations (see the counters below). Every record's ``ms`` is
CUDA-event time around the wrapper: the first main path's ms per step for
the step kernels (megastep, racestep), one isolated call for the solves
(admm, fused); the step kernels' ``paths`` key gives each other path's
launches, times, kernel-vs-plain check and bound. ``device_ms`` is the kernel's own
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
table phases, the fifth path, the racestep at N=12, the lap learner's
megastep, the planner, paths 6-9, ``[mega-cache]``, ``[cli]``, the
parallel layer's phases, the last slice's and ``[oracle]`` (which they
do not take), and runs every other
phase. A one-call A/B of a change
runs the parent's copy and the change's script in turn (parent, change,
change, parent) and compares their lines.

``--trace-megastep <dir>`` is ``[utils]``'s own child process (one traced
megastep launch). ``--two-cards`` (a host with two cards or more)
runs only ``[pipelined]``'s pipelined loop twice, with the planner on the
second card (its default placement there) and on a second stream of the
tracker's card, and requires the two runs to be bitwise equal.
"""

import bisect
import dataclasses
import json
import os
import subprocess
import sys
import time
import types
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
WITNESS_B, WITNESS_K = 256, 40   # [mega-cache]'s slice of the CPU witness (tests/test_torch_cache.py)
K_OBS_CMP = 3          # racestep steps held against plain with eyb and per-lane tables
OBS_SEGMENT = 60       # steps between block refreshes on main path 5
K_OBS_SEGMENTS = 9
SIGMA = (0.03, 0.01, 0.02, 0.01, 0.02, 0.01)
N_RACE = 12            # the race presets' tracker horizon (paths 6 and 7)
T_SWEEP = 600          # path 6: race_sweep's steps
T_RACE = 720           # path 7: the race preset's steps
T_RACE_PLAIN = 120     # path 7's smoke of the module composition on the card
REPLAN_EVERY = 60
T_RACE_LEARN = 900     # path 7b: the race preset in learn mode, on the oval
ILC_EVERY = 2
B_LEARN = 1024         # path 8: race_learn's cars, windows and window length
N_WINDOWS = 10
T_WINDOW = 300
N_LAP = 10             # path 9: lap learning at 4,096 cars (tests/test_lap_learning.py's N and learner)
N_LAPS = 6
T_LAP = 420
K_LAP_CMP = 5          # steps of the lap learner's megastep held against plain
B_CONFIG5 = 131072     # [config5]: BASELINE config 5's scale on one card (bench/presets.py::config5)
T_CONFIG5 = 30
CHUNK5 = 5             # steps of the checkpointed sweep's chunk measured at that scale
T_SHARD = 100          # [sharded]: the composed protocol through sharded_race_sweep
T_CKPT, CKPT_EVERY = 100, 50   # [ckpt]: checkpointed_sweep
CKPT_SAVES = 3                 # saves of its last state timed
T_GLOBAL = 250         # [global]: closed_loop_global (tests/test_global_loop.py's protocol)
GLOBAL_SIGMA = (0.02, 0.01, 0.02, 0.01, 0.01, 0.005)
T_MHE = 90             # [mhe]: tests/test_mhe.py's noisy protocol, W=8, n_gn=2
T_PIPE = 240           # [pipelined]: tests/test_planner.py:147-185's scenario at its size
PIPE_H = 192
PIPE_ITERS = 100       # the fused tracker's fixed count there (see [pipelined])
TRACE_STEPS = 30       # its traced window: from the plan for segment 2's issue over this many steps of segment 1
T_RT = 300             # [realtime]: 10 s of car time per run
K_EKF_EAGER = 30       # frames of its EKF run replayed by the eager filter
MHE_SIGMA = (0.05, 0.02, 0.05, 0.02, 0.02, 0.02)
MHE_CPU_LANES = 16
ORACLE_LANES = 32      # [oracle]: lanes checked on the B=4096 rungs, lanes 0 and B-1 among them
ORACLE_EVERY = 50      # the step stride of those checks
ORACLE_LAP_EVERY = 5   # and of the one-car laps' (tests/test_headline_oracle.py)
T_ORACLE_OVAL = 210    # one oval lap at vx_ref 1.5
T_ORACLE_LAP_MAX = 1200   # the racetrack lap must end within this many steps
ORACLE_NATIVE = 16     # QPs solved by both oracles
ORACLE_LAP_TOL = 5e-5  # tests/test_headline_oracle.py:98
ORACLE_TOL = 5e-4      # the production rung, tests/test_closed_loop.py:101
ORACLE_KERNEL_TOL = 2e-4   # kernel vs plain: the margin above plain on a lane that plain leaves out of bound
ORACLE_MIN_CONVERGED = 0.9
# the TPU run's quality numbers (PERF_TPU.md:117-133, 121-126, 548-553,
# 585-600), printed beside ours
TPU_SWEEP = {"corr": 0.956, "converged": 0.989, "ey_p99": 0.114}
TPU_RACE = {"mu_hat": 0.595, "lap_s": 13.97, "ey_rms": 0.043, "converged": 0.965}
TPU_RACE_LEARN = {"lap_s": [9.63, 8.03, 7.43], "mu_hat": 0.586, "converged": 0.981, "updates": 8}
TPU_LEARN = {"progress_first": 12.1, "progress_last": 20.3, "corner_corr": 0.69, "corner_lo": 1.81,
             "corner_hi": 2.09, "converged": 0.995}
TPU_LAPS = {"completed": 1.0, "improvement": 0.399, "ey_p99": 0.25}
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


def core_ops(S, tire, N, iters, builds=None):
    """group_core.cuh::mpc_core_g: per stage the curvature, friction cap,
    reference clamp, linear cost and warm-start clip; `builds` stage builds
    (N; fewer with the discretization cache); the folded cost; N factor
    stages; `iters` iterations; residuals and rho. The limp-home branch,
    which no converged lane takes, is not counted."""
    nx = S.A.shape[0]
    per_stage = SCALAR_OPS["kap_at"] + SCALAR_OPS["stage_cap"] + nx + 2 * NC
    builds = N if builds is None else builds
    return (builds * stage_build_ops(S, tire) + (N + 1) * per_stage + fold_ops(S)
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


def cache_floats(nx, N):
    """The megastep's discretization cache per lane, as the kernel writes
    it: Ad, Bd, the signature (Xs, Us, kappa) of N stages and the age."""
    return N * (nx * nx + nx * NU + nx + NU + 1) + 1


def cache_read_floats(nx, N, reuse):
    """What the cached kernel needs of the old cache per lane
    (group_core.cuh): the age and the signature of stages 1..N-1 but s for
    the drift, on every lane; stages 1..N-1 of Ad, Bd and s for the shift,
    on the reuse share of lanes. Stage 0 is never read."""
    return (N - 1) * ((nx - 1) + NU + 1) + 1 + reuse * (N - 1) * (nx * nx + nx * NU + 1)


def cache_drift_ops(nx, N):
    """group_core.cuh::prepare_g's drift over the stages k < N-1: per term
    (nx - 1 states, NU inputs, kappa) a subtraction, an absolute value, a
    division and a maximum; then the group's two maxima and the decision."""
    return (N - 1) * (nx + NU) * 4 + 3


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
    sides of the calls. The port's own spans, which the profiler also puts on
    the device's timeline (a span around a wrapper's copies, such as
    `fused_kernel.layout`), are no device operation and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def kernel_ms(fn, n, kernel, sessions=3):
    """Mean device time of one launch of the CUDA kernel whose name holds
    `kernel` over n calls of fn (torch.profiler: the kernel's own duration,
    without the wrapper's host work around it).

    The profiler has been seen to report fewer kernel records than launches
    that ran (8-9 of 10 in some sessions of this long-lived script; the
    records lost are the first of a session; cause not found, PERF.md §7).
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


def fits_note(kernel):
    """"; groups held at once ..." of the kernel's launch shapes so far, per
    path (utils.profiling.group_fits), or "" on a port without the reader."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import profiling

    read = getattr(profiling, "group_fits", None)
    if read is None:
        return ""
    return "; groups held at once: " + ", ".join(
        f"{smem} B {'co-resident' if res else 'clustered'} {n}" for (_, smem, res), n in sorted(read(kernel).items()))


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


ORACLE_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
RACE_KW = dict(n_sub=10, n_sub_ekf=4, sim_tire="pacejka")     # make_racestep_scan's filter and plant


def carry_lanes(c, idx):
    """The batch-first MPCCarry of lanes idx (a list, a tensor, or
    slice(None) for every lane) of a batch-last megastep or racestep carry."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import MPCCarry

    fb = lambda t: t[..., idx].movedim(-1, 0)
    return MPCCarry(X_pred=fb(c.X_pred), U_pred=fb(c.U_pred), s=fb(c.s), lam=fb(c.lam),
                    u_prev=fb(c.u_prev), rho=c.rho[idx])


def oracle_task(payload, native):
    """[oracle]'s worker: one lane's QP, the fields of a port BoxQP as numpy
    arrays, stacked and solved by the port's f64 oracle at its default
    settings. Returns (U[0], converged, primal_infeasible, iterations, and
    with `native` the C++ core's (converged, iterations, max |x - x_ref|))."""
    import torch

    sys.path.insert(0, HERE)
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle import (
        OsqpRefSettings, osqp_ref_solve, stack_boxqp, unstack_solution,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver.admm import BoxQP
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver.riccati import LQRCost, LQRDynamics

    torch.set_num_threads(1)
    if payload is None:            # the pool's warm-up: the imports alone
        return None
    dyn, cost, rest = payload
    t = torch.from_numpy
    qp = BoxQP(LQRDynamics(*map(t, dyn)), LQRCost(*map(t, cost)), *map(t, rest))
    stacked = stack_boxqp(qp)
    ref = osqp_ref_solve(*stacked, OsqpRefSettings())
    nat = None
    if native:
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle.native import osqp_native_solve

        n = osqp_native_solve(*stacked, OsqpRefSettings())
        nat = (n.converged, n.iters, float(np.abs(n.x - ref.x).max()))
    return unstack_solution(qp, ref.x)[1][0], ref.converged, ref.primal_infeasible, ref.iters, nat


def oracle_plain_of(rung, cells, saved):
    """For a cell rung of [oracle], the function of a checked step k that
    gives u0 (B, 2), indexed by global lane, of the rung's kernel's plain
    version from what ``saved[k]`` holds: (c) the megastep's carry, (d) the
    racestep's carry and that step's noise, (e-fused) and (e-admm) the state
    and the batch-first MPCCarry before the step. `cells` holds main()'s
    setup of cells 1-3 (see oracle_phase)."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import mpc_prepare, mpc_prepare_light
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.admm_kernel import admm_solve_plain
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.fused_kernel import fused_solve_plain
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import megastep_plain
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.racestep_kernel import racestep_plain
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver.scaling import ruiz_row_equilibrate, unscale_solution

    c = cells
    if rung == "c":
        return lambda k: megastep_plain(c.cfg, c.scfg, c.track, c.prm, c.x_ref, saved[k], n_sub=4)[1].T
    if rung == "d":
        return lambda k: racestep_plain(c.rcfg, c.scfg, c.track, c.rprm, c.table, *saved[k], c.mu_b, c.ekq, c.ekr,
                                        **RACE_KW)[1].T
    if rung == "e-fused":
        def fused_plain(k):
            xk, ck = saved[k]
            Xs, Us, kap, xr, lb, ub, x0a, warm = mpc_prepare_light(c.bscen.params, c.cfg, c.track, xk, c.x_ref, ck)
            return fused_solve_plain(c.cfg, c.fused_fixed, c.bscen.params, Xs, Us, kap, xr, lb, ub, x0a, warm[0],
                                     warm[1], ck.rho).U[:, 0]

        return fused_plain
    check(rung == "e-admm", f"[oracle] no plain version for rung {rung}")

    def admm_plain(k):
        xk, ck = saved[k]
        qp_b, warm, _ = mpc_prepare(c.scen.params, c.cfg, c.track, xk, c.x_ref, ck)
        qp_s, sc = ruiz_row_equilibrate(qp_b)
        s_w, lam_w, Xa_w, U_w = warm
        sol = admm_solve_plain(qp_s, c.scfg_admm, (s_w * sc.d, lam_w / sc.d, Xa_w, U_w), ck.rho)
        return unscale_solution(sol, sc).U[:, 0]

    return admm_plain


def oracle_gate(rung, rows, out, plain_of=None, suffix=""):
    """[oracle]'s numbers and gates for one rung. `rows` holds (step, global
    lane, kernel u0 (2,), kernel converged) per check and `out`
    oracle_task's answers for them. A lap rung (no `plain_of`): the oracle
    converged at every check, at least 40 checks, every |du| below
    ORACLE_LAP_TOL. A cell rung: at least ORACLE_MIN_CONVERGED of the
    lane-checks converged on both sides, each of those below ORACLE_TOL;
    where one is not, plain_of(step) (see oracle_plain_of) gives the plain
    version's u0 from the same carry. Plain out of bound too makes the
    lane's error the algorithm's, with the bound max(ORACLE_TOL, plain's
    |du| + ORACLE_KERNEL_TOL); plain within bound is a kernel fault. Logs
    the rung's line with `suffix` and returns its numbers."""
    du = np.array([np.abs(r[2] - o[0]).max() for r, o in zip(rows, out)])
    conv_k = np.array([r[3] for r in rows])
    conv_o = np.array([o[1] for o in out])
    pinf = np.array([o[2] for o in out])
    iters = np.array([o[3] for o in out])
    both = conv_k & conv_o
    q = lambda v, x: float(np.percentile(v, x)) if v.size else float("nan")
    g = du[both]
    s = {"checks": int(du.size), "converged_both": int(both.sum()), "p50": q(g, 50), "p99": q(g, 99),
         "max": float(g.max()) if g.size else float("nan"), "oracle_iters_median": q(iters, 50),
         "kernel_unconverged": int((~conv_k).sum()), "oracle_infeasible": int(pinf.sum()),
         "oracle_unconverged": int((~conv_o).sum()),
         "other_max": float(du[~both].max()) if (~both).any() else 0.0}
    log(f"[oracle] ({rung}) {s['checks']} checks, converged on both sides {s['converged_both']} "
        f"({s['converged_both'] / max(s['checks'], 1):.4f}): |du| p50 {s['p50']:.3e} p99 {s['p99']:.3e} "
        f"max {s['max']:.3e}; kernel not converged {s['kernel_unconverged']}, oracle infeasible "
        f"{s['oracle_infeasible']}, oracle not converged {s['oracle_unconverged']}, their |du| max "
        f"{s['other_max']:.3e}; oracle iterations median {s['oracle_iters_median']:.0f}{suffix}")
    if plain_of is None:
        check(conv_o.all(), f"[oracle] ({rung}) the oracle did not converge at {int((~conv_o).sum())} checks")
        check(s["checks"] >= 40, f"[oracle] ({rung}) only {s['checks']} checks")
        s["max_all"] = float(du.max())
        check(s["max_all"] < ORACLE_LAP_TOL, f"[oracle] ({rung}) max |u_kernel - u_oracle| {s['max_all']:.3e} >= "
              f"{ORACLE_LAP_TOL}")
        return s
    check(s["converged_both"] >= ORACLE_MIN_CONVERGED * s["checks"],
          f"[oracle] ({rung}) only {s['converged_both']} of {s['checks']} lane-checks converged on both sides")
    s["algorithmic_lanes"], plain_u = [], {}
    for i in np.flatnonzero(both & (du >= ORACLE_TOL)):
        step, lane = rows[i][0], rows[i][1]
        if step not in plain_u:
            plain_u[step] = plain_of(step).detach().cpu().double().numpy()
        du_p = float(np.abs(plain_u[step][lane] - out[i][0]).max())
        allowed = max(ORACLE_TOL, du_p + ORACLE_KERNEL_TOL)
        log(f"[oracle] ({rung}) step {step} lane {lane}: kernel |du| {du[i]:.3e} >= {ORACLE_TOL}; the plain "
            f"version from the same carry |du| {du_p:.3e}")
        check(du_p >= ORACLE_TOL, f"[oracle] ({rung}) step {step} lane {lane}: the plain version is within "
              f"{ORACLE_TOL} of the oracle ({du_p:.3e}) and the kernel is not ({du[i]:.3e}): a kernel fault")
        check(du[i] < allowed, f"[oracle] ({rung}) step {step} lane {lane}: kernel |du| {du[i]:.3e} beyond "
              f"max({ORACLE_TOL}, plain's {du_p:.3e} + {ORACLE_KERNEL_TOL})")
        s["algorithmic_lanes"].append({"step": int(step), "lane": int(lane), "du": float(du[i]), "du_plain": du_p,
                                       "bound": allowed})
    return s


def oracle_phase(dev, card, cells, reset_launches, read_launches):
    """[oracle]: each CUDA kernel held against the f64 OSQP oracle at the
    shapes its cells run. The QP of each checked lane-step is assembled by
    ``mpc_prepare`` from the carry the kernel steps from (the JAX package's
    tests/test_headline_oracle.py:73-85), solved on the host by the port's
    oracle in a pool of worker processes while the card drives on, and the
    kernel's u0 for that lane is compared with the oracle's U[0].

    (a) the megastep at B=1 over one oval lap (N=12), (b) over one racetrack
    lap (N=20, a sinusoidal reference table), every 5th step; (c) the
    megastep on cell 1, (d) the racestep on cell 2, (e) the fused kernel on
    cell 3 and the solver-only kernel on cell 1's admm steps, B_MAIN lanes
    for K_MAIN steps, ORACLE_LANES lanes every ORACLE_EVERY-th step (every
    admm step); the gates are oracle_gate's. `cells` holds main()'s setup of
    cells 1-3 and their final states (cell1_x, cell1_admm_x, cell2_xf,
    cell3_x): each rung re-drives its cell from the first state with that
    setup and must end bitwise on the cell's final state. 16 QPs are also
    solved by the native C++ core, which must give the numpy oracle's
    iterations and x within 1e-9 (tests/test_native.py:28-36)."""
    import concurrent.futures
    import multiprocessing

    import torch

    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
        MPCCarry, constant_refs, mpc_init, mpc_prepare, mpc_step_batched, plant_step,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import megastep, megastep_init, megastep_params
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.racestep_kernel import racestep, racestep_init
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle.native import native_available
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.oracle.stack import boxqp_lane
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import RefTable

    c = cells
    B, K = B_MAIN, K_MAIN
    t_phase = time.perf_counter()
    # the native core is built here, once, before any worker loads it
    check(native_available(), "[oracle] the native QP core (native/libosqpcore.so) can be neither found nor built")
    lanes_l = sorted({round(i * (B - 1) / (ORACLE_LANES - 1)) for i in range(ORACLE_LANES)})
    lanes = torch.tensor(lanes_l, device=dev)
    recs = {}          # rung -> [(step, lane, u kernel (2,), kernel converged, future)]
    saved = {}         # rung -> step -> what oracle_plain_of replays the step from
    drive_s = {}

    def params_lanes(pb, idx):
        return pb.replace(**{f.name: getattr(pb, f.name)[idx] for f in dataclasses.fields(pb)
                             if torch.is_tensor(getattr(pb, f.name)) and getattr(pb, f.name).dim() >= 1})

    def submit(rung, step, qp, lane_ids, u_k, conv_k, native=0):
        """Hand each lane of the batch-first QP to the pool; u_k (n, 2) and
        conv_k (n,) are the kernel's for those lanes. The first `native`
        lanes go to the native core too."""
        qp_cpu = type(qp)(type(qp.dyn)(*(t.cpu() for t in qp.dyn)), type(qp.cost)(*(t.cpu() for t in qp.cost)),
                          *(t.cpu() for t in qp[2:]))
        u_k, conv_k = u_k.detach().cpu().double().numpy(), conv_k.cpu().numpy()
        for i, b in enumerate(lane_ids):
            one = boxqp_lane(qp_cpu, i)
            payload = (tuple(t.numpy() for t in one.dyn), tuple(t.numpy() for t in one.cost),
                       tuple(t.numpy() for t in one[2:]))
            recs.setdefault(rung, []).append(
                (step, b, u_k[i], bool(conv_k[i]), pool.submit(oracle_task, payload, i < native)))

    prm1 = megastep_params(c.p, 1, device=dev)
    x0_lap = torch.tensor([[1.0, 0.0, 0.0, 0.0, 0.0, 0.05]], device=dev)

    def lap(rung, label, cfg_l, track_l, ref_l, T_max, until_lap=False):
        """The megastep at B=1 from x0_lap at the bench solver config; the
        QP of every 5th step to the oracle. T_max steps, or with `until_lap`
        until s passes the track's length at a check step."""
        t0 = time.perf_counter()
        car = megastep_init(c.p, cfg_l, track_l, x0_lap)
        L = float(track_l.length)
        reset_launches()
        t = 0
        while t < T_max:
            if t % ORACLE_LAP_EVERY == 0:
                if until_lap and float(car.x[4, 0]) > L:
                    break
                qp = mpc_prepare(c.p, cfg_l, track_l, car.x.T, ref_l, carry_lanes(car, [0]))[0]
            car_n, u0, dg = megastep(cfg_l, c.scfg, track_l, prm1, ref_l, car, n_sub=4)
            if t % ORACLE_LAP_EVERY == 0:
                submit(rung, t, qp, [0], u0.T, dg[2] > 0.5)
            car, t = car_n, t + 1
        read_launches(f"oracle-{rung}", {"megastep": t})
        s_end = float(car.x[4, 0])
        drive_s[rung] = time.perf_counter() - t0
        log(f"[oracle] ({rung}) {label}: {t} steps, s {s_end:.3f} m of a {L:.3f} m lap, "
            f"{len(recs[rung])} checks queued, drive {drive_s[rung]:.1f} s")
        check(s_end > L, f"[oracle] ({rung}) the car did not finish the lap: s {s_end:.3f} <= {L:.3f}")
        check(all(torch.isfinite(v).all() for v in car), f"[oracle] ({rung}) non-finite carry")

    def same_end(rung, what, got, cell_end):
        equal = torch.equal(got, cell_end)
        log(f"[oracle] ({rung}) {K if rung != 'e-admm' else K_ADMM_ROUTE} steps, drive {drive_s[rung]:.1f} s: "
            f"the final {what} bitwise the cell's: {equal}")
        check(equal, f"[oracle] ({rung}) re-drove its cell to another final {what} than the cell's run: it checks "
              f"another configuration")

    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    env_saved = {k: os.environ.get(k) for k in ORACLE_THREAD_VARS}
    os.environ.update(dict.fromkeys(ORACLE_THREAD_VARS, "1"))     # one BLAS thread per worker
    pool = concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        warm = [pool.submit(oracle_task, None, False) for _ in range(workers)]

        # (a) tests/test_headline_oracle.py's lap, (b) the racetrack's with a
        # sinusoidal racing line (tests/test_torch_closed_loop.py:161-170)
        ocfg = MPCConfig(N=12, model="dynamic")
        lap("a", "megastep B=1, oval, N=12, vx ref 1.5", ocfg, c.oval, constant_refs(ocfg, 1.5, device=dev),
            T_ORACLE_OVAL)
        L = float(c.track.length)
        n_tab = int(round(L / 0.05))
        w = 2 * np.pi * 3 * np.arange(n_tab) * (L / n_tab) / L
        tt = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
        sin_table = RefTable(ds=tt(L / n_tab), length=tt(L), vx=tt(1.5 + 0.3 * np.sin(w)), ey=tt(0.1 * np.sin(w)),
                             delta=tt(0.02 * np.cos(w)))
        lap("b", "megastep B=1, racetrack, N=20, sinusoidal reference table", c.cfg, c.track, sin_table,
            T_ORACLE_LAP_MAX, until_lap=True)

        # (c) cell 1 on the megastep
        p_l = params_lanes(c.scen.params, lanes)
        t0 = time.perf_counter()
        car, saved["c"] = megastep_init(c.scen.params, c.cfg, c.track, c.scen.x0), {}
        reset_launches()
        for k in range(K):
            if k % ORACLE_EVERY == 0:
                saved["c"][k] = car
                qp = mpc_prepare(p_l, c.cfg, c.track, car.x[:, lanes].T, c.x_ref, carry_lanes(car, lanes))[0]
            car_n, u0, dg = megastep(c.cfg, c.scfg, c.track, c.prm, c.x_ref, car, n_sub=4)
            if k % ORACLE_EVERY == 0:
                submit("c", k, qp, lanes_l, u0[:, lanes].T, dg[2, lanes] > 0.5,
                       native=ORACLE_NATIVE if k == 0 else 0)
            car = car_n
        read_launches("oracle-c", {"megastep": K})
        drive_s["c"] = time.perf_counter() - t0
        same_end("c", "state", car.x, c.cell1_x)

        # (e, second half) cell 1's admm steps on the solver-only kernel, from (c)'s final carry
        t0 = time.perf_counter()
        xs, ca, saved["e-admm"] = car.x.T.contiguous(), carry_lanes(car, slice(None)), {}
        reset_launches()
        for k in range(K_ADMM_ROUTE):
            saved["e-admm"][k] = (xs, ca)
            qp = mpc_prepare(p_l, c.cfg, c.track, xs[lanes], c.x_ref, MPCCarry(*(t[lanes] for t in ca)))[0]
            u, ca, dg = mpc_step_batched(c.scen.params, c.cfg, c.scfg_admm, c.track, xs, c.x_ref, ca)
            submit("e-admm", k, qp, lanes_l, u[lanes], dg.converged[lanes])
            xs = plant_step(c.scen.params, c.cfg, c.track, xs, u, n_sub=4)
        read_launches("oracle-e-admm", {"admm": K_ADMM_ROUTE})
        drive_s["e-admm"] = time.perf_counter() - t0
        same_end("e-admm", "state", xs, c.cell1_admm_x)

        # (d) cell 2 on the racestep: make_racestep_scan's step, drawn from
        # cell 2's generator. The tracker solves at the new filtered state,
        # with the old carry's mu-hat, warm start and sampled references
        # (ops/racestep_kernel.py::racestep_plain, steps 2-5)
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(1)
        rcar, saved["d"] = racestep_init(c.p, c.rcfg, c.track, c.x0r, 0.85), {}
        reset_launches()
        for k in range(K):
            noise = c.sig[:, None] * torch.randn((6, B), generator=gen, device=dev)
            new, u0, dg, _ = racestep(c.rcfg, c.scfg, c.track, c.rprm, c.table, rcar, noise, c.mu_b, c.ekq, c.ekr,
                                      **RACE_KW)
            if k % ORACLE_EVERY == 0:
                saved["d"][k] = (rcar, noise)
                qp = mpc_prepare(c.p_nom.replace(mu=rcar.fr[0, lanes]), c.rcfg, c.track, new.ekx[:, lanes].T,
                                 c.table, carry_lanes(rcar, lanes))[0]
                submit("d", k, qp, lanes_l, u0[:, lanes].T, dg[2, lanes] > 0.5)
            rcar = new
        read_launches("oracle-d", {"racestep": K})
        drive_s["d"] = time.perf_counter() - t0
        same_end("d", "filtered state", rcar.x_prev_f, c.cell2_xf)

        # (e) cell 3 on the fused kernel
        t0 = time.perf_counter()
        fp_l = params_lanes(c.bscen.params, lanes)
        fcar, fx, saved["e-fused"] = mpc_init(c.bscen.params, c.cfg, c.track, c.bscen.x0), c.bscen.x0, {}
        reset_launches()
        for k in range(K):
            if k % ORACLE_EVERY == 0:
                saved["e-fused"][k] = (fx, fcar)
                qp = mpc_prepare(fp_l, c.cfg, c.track, fx[lanes], c.x_ref, MPCCarry(*(t[lanes] for t in fcar)))[0]
            u, fcar_n, d = mpc_step_batched(c.bscen.params, c.cfg, c.fused_fixed, c.track, fx, c.x_ref, fcar)
            if k % ORACLE_EVERY == 0:
                submit("e-fused", k, qp, lanes_l, u[lanes], d.converged[lanes])
            fx, fcar = plant_step(c.bscen.params, c.cfg, c.track, fx, u, n_sub=4), fcar_n
        read_launches("oracle-e-fused", {"fused": K})
        drive_s["e-fused"] = time.perf_counter() - t0
        same_end("e-fused", "state", fx, c.cell3_x)

        # the oracle's answers, rung by rung
        t_wait = time.perf_counter()
        for f in warm:
            f.result()
        res = {rung: [f.result() for *_, f in rs] for rung, rs in recs.items()}
        log(f"[oracle] {sum(map(len, res.values()))} oracle solves in {workers} worker processes; waited "
            f"{time.perf_counter() - t_wait:.1f} s after the card's last rung")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for k, v in env_saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    summary = {}
    for rung in ("a", "b", "c", "d", "e-fused", "e-admm"):
        plain_of = oracle_plain_of(rung, c, saved[rung]) if rung in saved else None
        summary[rung] = oracle_gate(rung, [r[:4] for r in recs[rung]], res[rung], plain_of,
                                    f"; drive {drive_s[rung]:.1f} s ({card})")
        summary[rung]["drive_s"] = drive_s[rung]
    # both converged, the same iterations, x within 1e-9 (tests/test_native.py:28-36)
    nat = [o for out in res.values() for o in out if o[4] is not None]
    agree = [o[1] and o[4][0] and o[4][1] == o[3] and o[4][2] <= 1e-9 for o in nat]
    dx_max = max((o[4][2] for o in nat), default=float("nan"))
    log(f"[oracle] the native C++ core against the numpy oracle on {len(nat)} QPs: both converged, the same "
        f"iterations and x within 1e-9 on {sum(agree)}; max |dx| {dx_max:.3e}")
    check(len(nat) == ORACLE_NATIVE, f"[oracle] {len(nat)} QPs went to the native core, not {ORACLE_NATIVE}")
    check(all(agree), "[oracle] the native core and the numpy oracle disagree")
    summary["native"] = {"qps": len(nat), "agree": sum(agree), "max_dx": dx_max}
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[oracle] phase wall {summary['wall_s']:.1f} s ({card})")
    return summary


def main():
    t_script = time.perf_counter()
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
        # (entry, the untraced instantiation's flags after the operand
        # placement: the megastep's CACHE and TRACE, the others' TRACE; then
        # the vote slots' parameter pack, empty in the clustered one)
        for name, model, n_h, entry, mid in (
                ("megastep_kernel", "dynamic", N_MAIN, ("megastep_kernel", "Dynamic"), 2),
                ("megastep_kernel_kinematic", "kinematic", 10, ("megastep_kernel", "Kinematic"), 2),
                ("fused_kernel", "dynamic", N_MAIN, ("fused_kernel", "Dynamic"), 1),
                ("fused_kernel_kinematic", "kinematic", 10, ("fused_kernel", "Kinematic"), 1),
                ("racestep_kernel", "dynamic", N_MAIN, ("racestep_kernel",), 1)):
            sh = launch_shape(n_h, model)
            flags = f"Lb{int(sh.ops_in_smem)}E" + "Lb0E" * mid
            regs, spills = ptxas_usage(build_log, *entry, flags + "JEE")          # no vote slots
            regs_r, spills_r = ptxas_usage(build_log, *entry, flags + "JPNS_8VoteSlotE")
            log(f"[shape] {name} N={n_h}: {THREADS_PER_LANE} threads per lane, {LANES_PER_BLOCK} lanes "
                f"per block ({THREADS_PER_LANE * LANES_PER_BLOCK} threads), groups of {sh.cluster} "
                f"blocks, {-(-B_MAIN // 128) * sh.cluster} blocks at B={B_MAIN}, "
                f"{sh.smem_bytes} B dynamic shared memory per block (operands in "
                f"{'shared' if sh.ops_in_smem else 'device'} memory), clustered {regs} registers, "
                f"{spills} B spill stores; co-resident {regs_r} registers, {spills_r} B spill stores")
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
    # ---- 5d. the chosen shape on the first nb lanes: a clustered launch
    # holding more clusters than the card runs at once takes a second wave;
    # with early exit, a launch that fits the card whole runs co-resident,
    # in one wave (ops/csrc/arl_sync.cuh, launch_group) ----
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
            f"B={nb} ({-(-nb // 128)} groups) {ms:.4f}" for nb, ms in wave_ms.items()) + fits_note("fused_kernel")
            + f" ({card})")
    for name, (mcfg, mtrack, mprm, mref, mc0) in (("dynamic", (cfg, track, prm, x_ref, c0)),
                                                  ("kinematic", (kcfg, oval, kprm, kref, kc0))):
        wave_ms = {}
        for nb in (2048, 3840, B_MAIN):
            cut_car = type(mc0)(*(t[..., :nb].contiguous() for t in mc0))
            cut_prm = mprm[:, :nb].contiguous()
            wave_ms[nb] = kernel_ms(lambda: megastep(mcfg, scfg, mtrack, cut_prm, mref, cut_car, n_sub=4), 5,
                                    "megastep_kernel")
        log(f"[waves] megastep {name} N={mcfg.N}, device ms of the first step on the first B lanes: "
            + ", ".join(f"B={nb} ({-(-nb // 128)} groups) {ms:.4f}" for nb, ms in wave_ms.items())
            + fits_note("megastep_kernel") + f" ({card})")
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

    # ---- 5f. the megastep as the lap learner runs it (path 9's
    # instantiation): N=10, Pacejka controller and plant, 10 plant
    # sub-steps, path 9's cars (B=4096 on the oval, mu linspace(0.5, 1.2),
    # vx 1.0 from s=0) with (N+1, nx, B) references sampled from one table
    # per lane (vx and racing line differing by lane) along each step's
    # schedule. K_LAP_CMP steps: the kernel from plain's carry each step,
    # held to the megastep's bounds (u 2e-4 / x 5e-4 at a fixed count, 5e-3
    # at path 9's early exit); each version on its own carry reported ----
    lap = None
    if not ab:
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop.lap_learning import (
            batched_refs_from_tables, per_lane_table,
        )

        lcfg = MPCConfig(N=N_LAP, model="dynamic", tire="pacejka")
        scfg9 = SolverConfig(max_iter=50, early_exit=True, check_termination=2)
        loval = oval_track(ds=0.05)
        mu9 = torch.linspace(0.5, 1.2, B_MAIN, device=dev)
        p9 = p.replace(mu=mu9)
        x09 = torch.zeros((B_MAIN, 6), device=dev)
        x09[:, 0] = 1.0
        prm9 = megastep_params(p9, B_MAIN)
        tab9 = per_lane_table(initial_table(loval, ds=0.05, vx0=1.0), B_MAIN)
        lane_w = torch.linspace(0.0, 1.0, B_MAIN, device=dev)[:, None]
        node_w = torch.arange(tab9.vx.shape[1], device=dev) / 7.0
        tab9 = tab9.replace(vx=tab9.vx * (1.0 + 0.8 * lane_w), ey=0.08 * lane_w * torch.sin(node_w))
        refs9 = lambda c: batched_refs_from_tables(lcfg, tab9, torch.cat([c.x[4][None], c.X_pred[2:, 4],
                                                                          c.X_pred[-1:, 4]]))
        lap = {}
        for name, sc, tol_u, tol_x in (("fixed", scfg9.replace(early_exit=False, rho_interval=0), 2e-4, 5e-4),
                                       ("path config", scfg9, 5e-3, 5e-3)):
            ck = cp = megastep_init(p9, lcfg, loval, x09)
            err = dict.fromkeys(("u step", "x step", "X_pred step", "u own", "x own"), 0.0)
            for _ in range(K_LAP_CMP):
                ref = refs9(cp)
                cs, us, _ = megastep(lcfg, sc, loval, prm9, ref, cp, n_sub=10)
                ck, uk, dk = megastep(lcfg, sc, loval, prm9, refs9(ck), ck, n_sub=10)
                cp, up, dp = megastep_plain(lcfg, sc, loval, prm9, ref, cp, n_sub=10)
                torch.cuda.synchronize()
                for key, a, b in (("u step", us, up), ("x step", cs.x, cp.x), ("X_pred step", cs.X_pred, cp.X_pred),
                                  ("u own", uk, up), ("x own", ck.x, cp.x)):
                    err[key] = max(err[key], (a - b).abs().max().item())
            log(f"[mega-lap] N={N_LAP} Pacejka, per-lane table refs, B={B_MAIN} {name}: every lane one step from "
                f"plain's carry max|du|={err['u step']:.3e} max|dx|={err['x step']:.3e} "
                f"|dX_pred|={err['X_pred step']:.3e}; each on its own carry max|du|={err['u own']:.3e} "
                f"max|dx|={err['x own']:.3e}; done-at kernel {dk[4].mean().item():.3f} plain {dp[4].mean().item():.3f}")
            check(all(bool(torch.isfinite(t).all()) for t in (*ck, uk, *cs, us)), f"megastep N=10 {name}: not finite")
            check(err["u step"] <= tol_u and err["x step"] <= tol_x,
                  f"megastep N=10 Pacejka {name}: beyond ({tol_u}, {tol_x}) of plain one step from its carry")
            lap[name] = max(err["u step"], err["x step"])
        c9 = megastep_init(p9, lcfg, loval, x09)
        r9 = refs9(c9)
        megastep(lcfg, scfg9, loval, prm9, r9, c9, n_sub=10)                 # warm-up
        lap["device_ms"] = kernel_ms(lambda: megastep(lcfg, scfg9, loval, prm9, r9, c9, n_sub=10), 10,
                                     "megastep_kernel")
        lap["plain_ms"] = cuda_time_ms(lambda: megastep_plain(lcfg, scfg9, loval, prm9, r9, c9, n_sub=10), 3)
        log(f"[mega-lap] first step, path config: {lap['device_ms']:.4f} ms kernel (device), "
            f"{lap['plain_ms']:.3f} ms plain ({card})")

    if quick:
        log("[quick] kernel checks passed; stopping before the main path")
        return

    # ---- 6. main path 1: the tracker step ----
    wrappers = {"megastep": megastep, "admm": admm_kernel_solve, "racestep": racestep,
                "fused": fused_mpc_solve}

    def reset_launches():
        for w in wrappers.values():
            w.launches = 0
        megastep.cached_launches = 0

    def read_launches(label, expected):
        """Each wrapper's count since the reset (the megastep's cached
        instantiation as "megastep cached"); fails unless the path's
        kernels launched as `expected` and every other kernel not at all."""
        got = {k: w.launches for k, w in wrappers.items()}
        got["megastep cached"] = megastep.cached_launches
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
        xs, c = mcar.x.T.contiguous(), carry_lanes(mcar, slice(None))
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

    # ---- 6b. [mega-cache]: main path 1 with the megastep's discretization
    # cache (cache_build at its defaults: drift tolerance 0.3, max age 8) ----
    mega_cache = None
    if not ab:
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import (
            _megacache_drift, megacache_init,
        )

        t_phase = time.perf_counter()
        scfg_c = scfg.replace(cache_build=True)
        scfg_cf = scfg_c.replace(early_exit=False)        # the fixed count of the comparisons
        c0m = megastep_init(scen.params, cfg, track, scen.x0)
        # the first step: the saturated age forces a rebuild, bitwise the uncached step
        cu, uu, _ = megastep(cfg, scfg, track, prm, x_ref, c0m, n_sub=4)
        cc, uc, _, k1 = megastep(cfg, scfg_c, track, prm, x_ref, c0m, n_sub=4,
                                 cache=megacache_init(cfg, scfg_c, B))
        torch.cuda.synchronize()
        first_bitwise = torch.equal(uu, uc) and torch.equal(cu.x, cc.x)
        log(f"[mega-cache] first step: u and x bitwise equal to the uncached kernel: {first_bitwise}, "
            f"ages {sorted(set(k1.age.flatten().tolist()))}")
        check(first_bitwise and bool((k1.age == 0).all()), "[mega-cache] first step differs from the uncached kernel")

        # the path: K_MAIN cached steps of the bench protocol
        snap_steps = (1, 2, 3, 50, 250, K_MAIN - 1)
        snaps = {}
        reset_launches()
        carc, kc = c0m, megacache_init(cfg, scfg_c, B)
        conv_c = torch.empty(K_MAIN, device=dev)
        done_c = torch.empty((K_MAIN, B), device=dev)
        reuse_c = torch.empty(K_MAIN, device=dev)
        for k in range(K_MAIN):
            if k in snap_steps:
                snaps[k] = (carc, kc)
            if k == 1:
                start.record()
            carc, _, dgc, kc = megastep(cfg, scfg_c, track, prm, x_ref, carc, n_sub=4, cache=kc)
            conv_c[k] = dgc[2].mean()
            done_c[k] = dgc[4]
            reuse_c[k] = (kc.age > 0).float().mean()
        end.record()
        torch.cuda.synchronize()
        cache_ms = start.elapsed_time(end) / (K_MAIN - 1)
        cache_launches = read_launches("mega-cache", {"megastep cached": K_MAIN})
        held_c = [carc, kc]

        def cache_step():
            held_c[0], _, _, held_c[1] = megastep(cfg, scfg_c, track, prm, x_ref, held_c[0], n_sub=4,
                                                  cache=held_c[1])

        cache_dev_ms, cache_all_ms = step_device_ms(cache_step, 20, "megastep_kernel")
        snap = snaps[250]
        cache_plain_ms = cuda_time_ms(lambda: megastep_plain(cfg, scfg_c, track, prm, x_ref, snap[0], n_sub=4,
                                                             cache=snap[1]), 3)
        # where the time goes: one launch from step 250's carry and cache,
        # uncached, cached, and cached with every group forced to rebuild
        # (tolerance below 0) or to shift (no tolerance, no age limit)
        forced = {"uncached": (scfg, None), "cached": (scfg_c, snap[1]),
                  "rebuild": (scfg_c.replace(cache_drift_tol=-1.0), snap[1]),
                  "shift": (scfg_c.replace(cache_drift_tol=float("inf"), cache_max_age=1 << 30), snap[1])}
        split_ms = {name: kernel_ms(lambda: megastep(cfg, sc, track, prm, x_ref, snap[0], n_sub=4, cache=kk), 10,
                                    "megastep_kernel")
                    for name, (sc, kk) in forced.items()}

        def one_step_checks(mcfg, mtrack, mprm, mref, states, label):
            """The cached kernel and the plain version one step (fixed
            count) from the same carry and cache, on every lane: (max |du|,
            max |dx|, ages equal everywhere, smallest |drift - tol|)."""
            du = dx = 0.0
            same_age, margin = True, float("inf")
            for k, (c_s, k_s) in states:
                ck, uk, _, kk = megastep(mcfg, scfg_cf, mtrack, mprm, mref, c_s, n_sub=4, cache=k_s)
                cp, up, _, kp = megastep_plain(mcfg, scfg_cf, mtrack, mprm, mref, c_s, n_sub=4, cache=k_s)
                drift = _megacache_drift(mcfg, mtrack, c_s, k_s)
                torch.cuda.synchronize()
                du_k, dx_k = (uk - up).abs().max().item(), (ck.x - cp.x).abs().max().item()
                eq = torch.equal(kk.age, kp.age)
                m_k = (drift - scfg_c.cache_drift_tol).abs().min().item()
                log(f"[mega-cache] {label} step {k}: max|du|={du_k:.3e} max|dx|={dx_k:.3e} ages equal {eq}, "
                    f"groups rebuilding {(kp.age == 0).float().mean().item():.4f}, min |drift - tol| {m_k:.3e}")
                du, dx, same_age, margin = max(du, du_k), max(dx, dx_k), same_age and eq, min(margin, m_k)
            return du, dx, same_age, margin

        du_c, dx_c, ages_c, margin_c = one_step_checks(cfg, track, prm, x_ref, sorted(snaps.items()), "dynamic")
        check(du_c <= 2e-4 and dx_c <= 5e-4, f"[mega-cache] kernel beyond (2e-4, 5e-4) of plain: {du_c:.3e}, {dx_c:.3e}")
        check(ages_c, "[mega-cache] kernel and plain took different branches")

        # the kinematic model on BASELINE config 1's batched configuration
        kfirst = megastep(kcfg, scfg, oval, kprm, kref, megastep_init(kscen.params, kcfg, oval, kscen.x0), n_sub=4)
        kc_car = megastep_init(kscen.params, kcfg, oval, kscen.x0)
        kc_cache = megacache_init(kcfg, scfg_c, B_MAIN)
        ksnaps = []
        for k in range(20):
            if k in (1, 2, 5, 10, 19):
                ksnaps.append((k, (kc_car, kc_cache)))
            kc_car, ku, _, kc_cache = megastep(kcfg, scfg_c, oval, kprm, kref, kc_car, n_sub=4, cache=kc_cache)
            if k == 0:
                torch.cuda.synchronize()
                kin_bitwise = torch.equal(ku, kfirst[1]) and torch.equal(kc_car.x, kfirst[0].x)
        du_k, dx_k, ages_k, margin_k = one_step_checks(kcfg, oval, kprm, kref, ksnaps, "kinematic")
        log(f"[mega-cache] kinematic: first step bitwise {kin_bitwise}, reuse share over 20 steps "
            f"{(kc_cache.age > 0).float().mean().item():.4f} at the last")
        check(kin_bitwise, "[mega-cache] kinematic first step differs from the uncached kernel")
        check(du_k <= 2e-4 and dx_k <= 5e-4, f"[mega-cache] kinematic kernel beyond (2e-4, 5e-4) of plain")
        check(ages_k, "[mega-cache] kinematic kernel and plain took different branches")

        # per-step |du| against the uncached kernel forked from the same
        # carry (the uncached carry threaded, the cache along with it)
        car_f, k_f = c0m, megacache_init(cfg, scfg_c, B)
        du_f = torch.empty((K_MAIN, B), device=dev)
        reuse_slice = torch.empty(K_MAIN, device=dev)
        for k in range(K_MAIN):
            car_n, u_a, _ = megastep(cfg, scfg, track, prm, x_ref, car_f, n_sub=4)
            _, u_b, _, k_f = megastep(cfg, scfg_c, track, prm, x_ref, car_f, n_sub=4, cache=k_f)
            du_f[k] = (u_a - u_b).abs().amax(dim=0)
            reuse_slice[k] = (k_f.age[0, :WITNESS_B] > 0).float().mean()
            car_f = car_n
        torch.cuda.synchronize()
        du_step = du_f.amax(dim=1)
        # the slice that tests/test_torch_cache.py::test_cache_quality_matches_jax
        # computes on the CPU with the JAX kernel and the plain version:
        # lanes 0-255 (groups 0 and 1), steps 1-40 of the fork
        du_w = du_f[:WITNESS_K, :WITNESS_B]
        reuse_w = reuse_slice[:WITNESS_K].mean().item()
        q = lambda t, v: torch.quantile(t.flatten().float(), v).item()
        conv_c_last = conv_c[-100:].mean().item()
        reuse = reuse_c.mean().item()
        finite_c = all(bool(torch.isfinite(t).all()) for t in (*carc, *kc))
        mega_cache = {
            "launches": cache_launches["megastep cached"], "ms": cache_ms, "device_ms": cache_dev_ms,
            "device_ms_all": cache_all_ms, "plain_ms": cache_plain_ms, "max_abs_err": max(du_c, dx_c),
            "kinematic_max_abs_err": max(du_k, dx_k), "reuse": reuse, "drift_margin": min(margin_c, margin_k),
            "du_median": q(du_f, 0.5), "du_p95": q(du_f, 0.95), "du_max": du_f.max().item(),
            "du_step_median": q(du_step, 0.5), "iters": executed_iters(done_c), "split_device_ms": split_ms,
            "witness": {"reuse": reuse_w, "du_median": q(du_w, 0.5), "du_p95": q(du_w, 0.95),
                        "du_max": du_w.max().item()}}
        log(f"[mega-cache] K={K_MAIN} B={B} N={N_MAIN}: {cache_ms:.4f} ms/step events, device per step: megastep "
            f"{cache_dev_ms:.4f} ms, every device operation {cache_all_ms:.4f} ms; uncached [main] {mega_ms:.4f} "
            f"ms/step events, {main_dev_ms:.4f} ms device; plain {cache_plain_ms:.3f} ms/step ({card})")
        log("[mega-cache] device ms per launch from step 250's carry: " + ", ".join(
            f"{name} {ms:.4f}" for name, ms in split_ms.items()) + f" ({card})")
        log(f"[mega-cache] reuse share {reuse:.4f}, converged {conv_c.mean().item():.4f} (last 100: "
            f"{conv_c_last:.4f}), mean done-at {done_c.mean().item():.3f}/20, finite={finite_c}")
        log(f"[mega-cache] per lane-step |du| against the uncached kernel forked from the same carry over "
            f"{K_MAIN} steps: median {mega_cache['du_median']:.3e}, p95 {mega_cache['du_p95']:.3e}, max "
            f"{mega_cache['du_max']:.3e} (per-step maxima: median {mega_cache['du_step_median']:.3e}); the TPU "
            f"run's ~1e-6 / ~3e-3 / 1.7e-2 (PERF_TPU.md:276-281)")
        w = mega_cache["witness"]
        log(f"[mega-cache] lanes 0-{WITNESS_B - 1}, fork steps 1-{WITNESS_K} (the CPU witness's slice, "
            f"tests/test_torch_cache.py): reuse {w['reuse']:.4f}, |du| median {w['du_median']:.3e}, p95 "
            f"{w['du_p95']:.3e}, max {w['du_max']:.3e}")
        log(f"[mega-cache] kernel vs plain: max|du,dx| {mega_cache['max_abs_err']:.3e} dynamic, "
            f"{mega_cache['kinematic_max_abs_err']:.3e} kinematic, smallest |drift - tol| seen "
            f"{mega_cache['drift_margin']:.3e}; phase wall {time.perf_counter() - t_phase:.1f} s")
        check(finite_c, "[mega-cache] non-finite carry or cache")
        check(conv_c_last >= 0.99, f"[mega-cache] converged (last 100) {conv_c_last:.4f} < 0.99")

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
                   finite=bool(torch.isfinite(fx).all()), x=fx,
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

    # ---- 8b. [oracle]: every kernel against the f64 OSQP oracle, on the
    # headline laps and on cells 1-3 re-driven from their first states with
    # their own setup, each held to end on the cell's final state ----
    if not ab:
        cells = types.SimpleNamespace(
            p=p, cfg=cfg, track=track, x_ref=x_ref, oval=oval, scfg=scfg, scen=scen, prm=prm, scfg_admm=scfg_admm,
            rcfg=rcfg, rprm=rprm, table=table, x0r=x0r, mu_b=mu_b, p_nom=p_nom, sig=sig, ekq=ekq, ekr=ekr,
            bscen=bscen, fused_fixed=fused_fixed, cell1_x=car.x, cell1_admm_x=xs, cell2_xf=Xf[-1],
            cell3_x=fused_bench["x"])
        oracle_phase(dev, card, cells, reset_launches, read_launches)

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
    plan = sweep = race7 = race7b = learn8 = lap9 = None
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

        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import LapLearnConfig, mega_race_learn
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import lap_learning as ll_mod
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import megastep_kernel as mk_mod

        def timed(fn, into):
            """fn, with the wall time of each call (synchronized on both
            sides) appended to `into`."""
            def call(*a, **k):
                out, ms = wall_ms(lambda: fn(*a, **k))
                into.append(ms)
                return out
            return call

        def recording(launcher, into):
            """A kernel launcher that appends each launch's done-at row."""
            def call(*a, **k):
                out = launcher(*a, **k)
                into.append(out[2][4])
                return out
            return call

        # ---- 12b. main path 7b: the race preset in learn mode on the oval:
        # race_loop on the racestep at B=1 from the table0 seed (no plan),
        # the lap learner refining the table every ILC_EVERY segments ----
        oval7 = oval_track()
        upd7b, plans7b = [], []
        race_mod.learn_from_lap = timed(race_mod.learn_from_lap, upd7b)
        race_mod.plan_mpp = timed(plan_mpp, plans7b)
        try:
            reset_launches()
            log7b, wall7b = wall_ms(lambda: race_loop(
                p, rcfg12, scfg7, pcfg, oval7, x07, T=T_RACE_LEARN, mu_true=0.6, mu0=1.0,
                replan_every=REPLAN_EVERY, noise_sigma=SIGMA, seed=71, ilc_every=ILC_EVERY,
                ilc_cfg=LapLearnConfig(gain=0.7, dv_max=0.8), table0=initial_table(oval7, ds=0.05, vx0=1.0),
                backend="mega"))
            race7b = {"launches": read_launches("race-loop-learn", {"racestep": T_RACE_LEARN}), "wall_ms": wall7b}
        finally:
            race_mod.learn_from_lap = ll_mod.learn_from_lap
            race_mod.plan_mpp = plan_mpp
        check(not plans7b, "[race-loop-learn] planned, though the table0 seed replaces the plan")
        steps7b = log7b.lap_steps.tolist()
        ey7b = log7b.Xf[:, 5]
        race7b.update(
            lap_s=[round((b - a) * rcfg12.dt, 3) for a, b in zip([0] + steps7b[:-1], steps7b)],
            mu_hat=log7b.mu_hat[-1].item(), converged=log7b.converged.mean().item(),
            updates=log7b.replan_steps.numel() - 1, update_ms=float(np.mean(upd7b)),
            ey_rms=ey7b.pow(2).mean().sqrt().item(), ey_max=ey7b.abs().max().item(),
            finite=all(bool(torch.isfinite(getattr(log7b, f)).all())
                       for f in ("Xg", "Xf", "U", "mu_hat", "tables_vx", "tables_ey")))
        race7b["ms"] = (wall7b - sum(upd7b)) / T_RACE_LEARN
        log(f"[race-loop-learn] T={T_RACE_LEARN} B=1 N={N_RACE} mega, oval, learn mode: lap times "
            f"{race7b['lap_s']} s (TPU run {TPU_RACE_LEARN['lap_s']} s), mu-hat final {race7b['mu_hat']:.4f} (TPU "
            f"run {TPU_RACE_LEARN['mu_hat']}), converged {race7b['converged']:.4f} (TPU run "
            f"{TPU_RACE_LEARN['converged']}), table updates {race7b['updates']} at steps "
            f"{log7b.replan_steps.tolist()[1:]} (TPU run {TPU_RACE_LEARN['updates']}), e_y rms "
            f"{race7b['ey_rms']:.4f} max {race7b['ey_max']:.4f}, finite={race7b['finite']}")
        log(f"[race-loop-learn] wall {wall7b:.1f} ms: {len(upd7b)} table updates {sum(upd7b):.1f} ms "
            f"({race7b['update_ms']:.2f} ms each), segments {race7b['ms']:.4f} ms/step ({card})")
        check(race7b["finite"], "[race-loop-learn] non-finite output")
        check(len(race7b["lap_s"]) >= 2, f"[race-loop-learn] {len(race7b['lap_s'])} laps < 2")
        check(len(race7b["lap_s"]) >= 2 and race7b["lap_s"][-1] < race7b["lap_s"][0],
              "[race-loop-learn] the last lap is not faster than the first")
        check(race7b["ey_max"] < 0.45, f"[race-loop-learn] |e_y| max {race7b['ey_max']:.4f} >= 0.45")

        # ---- 13. main path 8: race_learn (bench/presets.py:562-630) at the
        # TPU run's size: B_LEARN cars on the racetrack, each following its
        # own table on the racestep, the learner refining every lane's table
        # between windows at its own mu-hat ----
        scfg8 = SolverConfig(max_iter=50, rho_interval=0, early_exit=True, check_termination=2)
        mu8 = torch.linspace(0.45, 1.2, B_LEARN, device=dev)
        x08 = torch.zeros((B_LEARN, 6), device=dev)
        x08[:, 0] = 1.0
        x08[:, 4] = torch.arange(B_LEARN, device=dev, dtype=torch.float32) * (float(track.length) / B_LEARN)
        upd8, win8, done8 = [], [], []
        scan = race_mod.make_racestep_scan

        def timed_scan(*a, **k):
            return timed(scan(*a, **k), win8)

        launch_race = rk_mod._racestep_cuda
        race_mod.learn_from_lap = timed(race_mod.learn_from_lap, upd8)
        race_mod.make_racestep_scan = timed_scan
        rk_mod._racestep_cuda = recording(launch_race, done8)
        try:
            reset_launches()
            log8, wall8 = wall_ms(lambda: mega_race_learn(
                p, rcfg12, scfg8, track, x08, n_windows=N_WINDOWS, T_window=T_WINDOW, mu_true_b=mu8, mu0=0.825,
                noise_sigma=SIGMA, llcfg=LapLearnConfig(gain=0.5, dv_max=0.5),
                table0=initial_table(track, ds=0.05, vx0=1.2), seed=8))
            learn8 = {"launches": read_launches("race-learn", {"racestep": N_WINDOWS * T_WINDOW}), "wall_ms": wall8}
        finally:
            race_mod.learn_from_lap = ll_mod.learn_from_lap
            race_mod.make_racestep_scan = scan
            rk_mod._racestep_cuda = launch_race
        mu_true8 = mu8.cpu().numpy()
        mu_fin8 = log8.mu_hat[-1, :, -1].cpu().numpy()
        kap8 = track.kappa.abs().cpu().numpy()
        n8 = log8.tables_vx.shape[-1]
        node_kap = kap8[np.clip(((np.arange(n8) * float(log8.table.ds[0])) / float(track.ds)).astype(int), 0,
                                kap8.size - 1)]
        corner = torch.as_tensor(node_kap > 0.5 * kap8.max(), device=dev)
        cv = log8.tables_vx[-1][:, corner].mean(dim=1).cpu().numpy()
        prog8 = log8.progress.cpu().numpy()
        learn8.update(
            ms=sum(win8) / (N_WINDOWS * T_WINDOW), update_ms=float(np.mean(upd8)),
            mu_corr=float(np.corrcoef(mu_fin8, mu_true8)[0, 1]), corner_corr=float(np.corrcoef(cv, mu_true8)[0, 1]),
            corner_lo=float(cv[:B_LEARN // 4].mean()), corner_hi=float(cv[-B_LEARN // 4:].mean()),
            progress_first=float(np.median(prog8[0])), progress_last=float(np.median(prog8[-1])),
            converged=log8.converged.mean().item(),
            finite=all(bool(torch.isfinite(t).all()) for t in (log8.tables_vx, log8.mu_hat, log8.progress,
                                                               log8.Xf_last, log8.converged)))
        log(f"[race-learn] B={B_LEARN} {N_WINDOWS} windows of {T_WINDOW} N={N_RACE} racetrack: "
            f"{learn8['ms']:.4f} ms/composed step ({B_LEARN / learn8['ms'] * 1e3:.0f} composed solves/s), "
            f"{learn8['update_ms']:.2f} ms per ILC update of {B_LEARN} tables ({card}); wall {wall8:.1f} ms")
        log(f"[race-learn] median window progress first {learn8['progress_first']:.2f} m last "
            f"{learn8['progress_last']:.2f} m (TPU run {TPU_LEARN['progress_first']} -> {TPU_LEARN['progress_last']}), "
            f"mu-hat/mu-true corr {learn8['mu_corr']:.4f}, corner vx vs mu corr {learn8['corner_corr']:.4f} (TPU run "
            f"{TPU_LEARN['corner_corr']}), corner vx low / high quartile {learn8['corner_lo']:.3f} / "
            f"{learn8['corner_hi']:.3f} (TPU run {TPU_LEARN['corner_lo']} / {TPU_LEARN['corner_hi']}), converged "
            f"{learn8['converged']:.4f} (TPU run {TPU_LEARN['converged']}), finite={learn8['finite']}")
        # the path's instantiation (N=12, per-lane tables: the learned ones,
        # B_LEARN cars) against plain, every lane one step from plain's
        # carry: the racestep's bounds, tight at a fixed count and 5e-3 at
        # the path's early exit
        prm8 = megastep_params(p.replace(mu=0.825), B_LEARN)
        err8 = {}
        for name, sc, bnd in (("fixed", scfg8.replace(early_exit=False), tight), ("path config", scfg8, loose)):
            cp8 = racestep_init(p, rcfg12, track, x08, 0.825)
            e8 = dict.fromkeys(bnd, 0.0)
            for k in range(K_RACE_CMP):
                a = (rcfg12, sc, track, prm8, log8.table)
                nz = noises[k][:, :B_LEARN].contiguous()
                cs, us, _, zs = racestep(*a, cp8, nz, mu8, ekq, ekr)
                cp8, up, _, zp = racestep_plain(*a, cp8, nz, mu8, ekq, ekr)
                torch.cuda.synchronize()
                for key, x, y in (("u0", us, up), ("z", zs, zp)) + tuple(
                        (f, getattr(cs, f), getattr(cp8, f)) for f in ("xg", "ekx", "fr", "X_pred")):
                    e8[key] = max(e8[key], (x - y).abs().max().item())
            log(f"[race-learn] racestep N={N_RACE} per-lane learned tables B={B_LEARN} {name}, every lane one step "
                f"from plain's carry: " + " ".join(f"max|d{key}|={v:.3e}" for key, v in e8.items()))
            for key, tol in bnd.items():
                check(e8[key] <= tol, f"[race-learn] racestep {name}: |d{key}| {e8[key]:.3e} beyond {tol} of plain")
            err8[name] = max(e8.values())
        args8 = (rcfg12, scfg8, track, prm8, log8.table, racestep_init(p, rcfg12, track, x08, 0.825),
                 noises[0][:, :B_LEARN].contiguous(), mu8, ekq, ekr)
        racestep(*args8)                                                # warm-up
        learn8.update(err=err8, device_ms=kernel_ms(lambda: racestep(*args8), 10, "racestep_kernel"),
                      plain_ms=cuda_time_ms(lambda: racestep_plain(*args8), 3))
        log(f"[race-learn] first step, path config: {learn8['device_ms']:.4f} ms kernel (device), "
            f"{learn8['plain_ms']:.3f} ms plain ({card})")
        check(learn8["finite"], "[race-learn] non-finite output")
        check(learn8["converged"] >= 0.95, f"[race-learn] converged {learn8['converged']:.4f} < 0.95")
        check(learn8["progress_last"] > learn8["progress_first"],
              "[race-learn] the last window's median progress is not above the first's")

        # ---- 14. main path 9: lap learning at 4,096 cars
        # (PERF_TPU.md:585-600; its N and learner from
        # tests/test_lap_learning.py:112-136): batched_lap_learning on the
        # megastep, one launch per step, per-lane tables sampled on the host ----
        upd9, lap_ms9, done9 = [], [], []
        rollout = ll_mod.mega_lap_rollout
        learn_fn = ll_mod.learn_from_lap
        launch_mega = mk_mod._megastep_cuda

        def timed_rollout(*a, **k):
            return timed(rollout(*a, **k), lap_ms9)

        ll_mod.mega_lap_rollout = timed_rollout
        ll_mod.learn_from_lap = timed(learn_fn, upd9)
        mk_mod._megastep_cuda = recording(launch_mega, done9)
        try:
            reset_launches()
            log9, wall9 = wall_ms(lambda: ll_mod.batched_lap_learning(
                p9, lcfg, scfg9, loval, x09, N_LAPS, T_LAP,
                llcfg=LapLearnConfig(gain=0.7, dv_max=0.8, a_lat_frac=0.78),
                table0=initial_table(loval, ds=0.05, vx0=1.0), sim_tire="pacejka", backend="mega"))
            lap9 = {"launches": read_launches("lap-learn", {"megastep": N_LAPS * T_LAP}), "wall_ms": wall9}
        finally:
            ll_mod.mega_lap_rollout = rollout
            ll_mod.learn_from_lap = learn_fn
            mk_mod._megastep_cuda = launch_mega
        # the device's time per step: 20 steps of the rollout on the learned tables
        run20 = rollout(p9, lcfg, scfg9, loval, 20, sim_tire="pacejka")
        dev_kernel, dev_all = step_device_ms(lambda: run20(x09, log9.table), 1, "megastep_kernel")
        laps9 = log9.lap_steps.numpy()
        done_last = laps9[-1] <= T_LAP
        impr = 1.0 - laps9[-1] / laps9[0]
        ey9 = log9.last_log.X[..., 5].abs().flatten().cpu().numpy()
        lap9.update(
            ms=sum(lap_ms9) / (N_LAPS * T_LAP), device_ms_step=dev_all / 20, kernel_ms_step=dev_kernel,
            update_ms=float(np.mean(upd9)),
            completed=float((laps9 <= T_LAP).mean()), completed_last=float(done_last.mean()),
            improvement=float(np.median(impr)), ey_p99=float(np.percentile(ey9, 99)),
            lap_s_first=float(np.median(laps9[0])) * lcfg.dt, lap_s_last=float(np.median(laps9[-1])) * lcfg.dt,
            converged=log9.last_log.converged.mean().item(),
            finite=all(bool(torch.isfinite(t).all()) for t in (log9.tables_vx, *log9.last_log)))
        lap9["host_share"] = 1.0 - lap9["device_ms_step"] / lap9["ms"]
        log(f"[lap-learn] B={B_MAIN} {N_LAPS} laps of {T_LAP} N={N_LAP} Pacejka oval: {lap9['ms']:.4f} ms/step events "
            f"({B_MAIN / lap9['ms'] * 1e3:.0f} solves/s), device {lap9['device_ms_step']:.4f} ms/step of which the "
            f"megastep {lap9['kernel_ms_step']:.4f} (host share {lap9['host_share']:.2f}), {lap9['update_ms']:.2f} ms "
            f"per update of {B_MAIN} tables ({card}); wall "
            f"{wall9:.1f} ms")
        log(f"[lap-learn] laps completed {lap9['completed']:.4f} (last lap {lap9['completed_last']:.4f}; TPU run "
            f"{TPU_LAPS['completed']}), median lap {lap9['lap_s_first']:.3f} -> {lap9['lap_s_last']:.3f} s, median "
            f"improvement {lap9['improvement']:.4f} (TPU run {TPU_LAPS['improvement']}), |e_y| p99 {lap9['ey_p99']:.4f} "
            f"(TPU run {TPU_LAPS['ey_p99']}), converged (last lap) {lap9['converged']:.4f}, finite={lap9['finite']}")
        check(lap9["finite"], "[lap-learn] non-finite output")
        check(lap9["completed_last"] >= 0.99, f"[lap-learn] last lap completed on {lap9['completed_last']:.4f} < 0.99")
        check(lap9["improvement"] > 0.25, f"[lap-learn] median improvement {lap9['improvement']:.4f} <= 0.25")
        check(lap9["ey_p99"] < 0.4, f"[lap-learn] |e_y| p99 {lap9['ey_p99']:.4f} >= 0.4")

    # ---- 15. [cli]: the experiment command line (python -m ... run <preset>)
    # in-process through cli.main, each result parsed from its JSON; each
    # run's kernel launches counted like a main path's ----
    if not ab:
        import contextlib
        import io

        from autonomous_racing_lpv_mpp_mpc_tpu_torch import cli
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.bench import run_preset

        t_phase = time.perf_counter()

        def cli_out(*argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(list(argv))
            check(rc == 0, f"[cli] {' '.join(argv)} returned {rc}")
            return buf.getvalue()

        def cli_run(label, expected, *argv, fn=None):
            """One preset run (the CLI's, or `fn`): its result, its wall time
            and its launches, which must be `expected`."""
            reset_launches()
            t_run = time.perf_counter()
            res = fn() if fn is not None else json.loads(cli_out("run", *argv))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
            read_launches(f"cli {label}", expected)
            log(f"[cli] {label} ({' '.join(argv) if argv else 'run_preset'}): {wall:.1f} s wall; "
                + json.dumps({k: v for k, v in res.items() if k != "preset"}))
            return res

        names = sorted(line.split(":")[0] for line in cli_out("list").strip().splitlines())
        jax_names = ["adaptive", "config1", "config1_planner", "config2", "config3", "config4", "config5",
                     "latency", "learn", "race", "race_learn", "race_sweep"]
        log(f"[cli] list: {names}")
        check(names == jax_names, "[cli] list does not name the JAX package's 12 presets")

        r = cli_run("config1 fused", {"fused": 400}, "config1", "backend=fused")
        check(r["laps"] >= 1 and r["ey_max_m"] < 0.4 and r["converged_frac"] > 0.9,
              "[cli] config1 fused: not a healthy lap (laps >= 1, |e_y| max < 0.4, converged > 0.9)")
        r = cli_run("config2 fused", {"fused": 700}, "config2", "backend=fused")
        check(r["laps"] >= 1 and r["ey_max_m"] < 0.4, "[cli] config2 fused: not a healthy lap")
        r = cli_run("config3 fused", {"fused": 800}, "config3", "backend=fused")
        lap_err = abs(r["lap_times_s"][0] / r["planner_lap_time_s"] - 1.0) if r["lap_times_s"] else float("inf")
        log(f"[cli] config3: first lap {r['lap_times_s'][:1]} s against the plan's {r['planner_lap_time_s']} s "
            f"({lap_err:.3f} off)")
        check(r["planner_sqp_converged"] and lap_err < 0.15,
              "[cli] config3 fused: the planner did not converge or the lap is not within 15% of the plan")
        r = cli_run("config1_planner fused", {"fused": 500}, "config1_planner", "backend=fused")
        lap_err = abs(r["lap_times_s"][-1] / r["planner_lap_time_s"] - 1.0) if r["lap_times_s"] else float("inf")
        check(r["planner_sqp_converged"] and lap_err < 0.15 and r["ey_max_m"] < 0.4 and r["converged_frac"] > 0.9,
              "[cli] config1_planner fused: the plan did not converge, the last lap is not within 15% of it, "
              "|e_y| max >= 0.4 or converged <= 0.9")
        r = cli_run("adaptive fused", {"fused": 800}, "adaptive", "backend=fused")
        check(abs(r["mu_hat_final"] - 0.5) < 0.05 and r["ey_rms_adapted_m"] < r["ey_rms_frozen_m"],
              "[cli] adaptive fused: mu-hat not within 0.05 of 0.5 or no gain over the frozen arm")
        t_lap = int(1.4 * float(oval_track(ds=0.05).length) / (1.0 * MPCConfig(N=12).dt))
        r = cli_run("learn fused", {"fused": 6 * t_lap}, "learn", "backend=fused")
        check(r["improvement_pct"] > 3 and r["ey_max_m"] < 0.4, "[cli] learn fused: no improvement or |e_y| >= 0.4")
        for route, kernel in (("fused", "fused"), ("admm", "admm")):
            r = cli_run(f"config4 {route}", {kernel: 20}, "config4", f"backend={route}")
            check(r["converged_frac"] >= 0.99, f"[cli] config4 {route}: converged {r['converged_frac']} < 0.99")
        r = cli_run("latency fused", {"fused": 71}, "latency", "backend=fused")
        check(0 < r["p50_ms"] <= r["p99_ms"] and r["on_device_step_ms"] > 0, "[cli] latency: bad times")
        r = cli_run("race_sweep", {"racestep": 600}, "race_sweep")
        check(r["converged_frac"] >= 0.95, f"[cli] race_sweep: converged {r['converged_frac']} < 0.95")
        r = cli_run("race_learn", {"racestep": 8 * 300}, "race_learn")
        check(r["converged_frac"] >= 0.95 and r["progress_m_last_window"] > r["progress_m_first_window"],
              "[cli] race_learn: converged < 0.95 or no progress gained over the windows")
        r = cli_run("race mega", {"racestep": 240}, fn=lambda: run_preset("race", backend="mega", T=240))
        check(np.isfinite(r["mu_hat_final"]) and r["ey_max_m"] < 0.45,
              "[cli] race mega: non-finite, or |e_y| max >= 0.45 (tests/test_race.py:47)")
        r = cli_run("race plain", {}, "race", "T=30")
        check(np.isfinite(r["mu_hat_final"]) and r["ey_max_m"] < 0.45,
              "[cli] race on the plain route: non-finite, or |e_y| max >= 0.45 (tests/test_race.py:47)")
        r = cli_run("config1 plain", {}, "config1", "T=30")
        check(r["converged_frac"] > 0.9 and r["ey_max_m"] < 0.4, "[cli] config1 on the plain route: unhealthy")
        cli_wall = time.perf_counter() - t_phase
        log(f"[cli] phase wall {cli_wall:.1f} s ({card})")

    # ---- 16. the parallel layer, the world-frame loop and MHE,
    # each path driven with the counts set to 0 just before it and read just
    # after: [config5] BASELINE config 5 at its scale on the one card (world
    # size 1, NCCL), [sharded] the sharded entry points against their
    # unsharded paths, [ckpt] the checkpointed sweep killed and resumed,
    # [global] the world-frame loop, [mhe] the moving-horizon estimator ----
    par = None
    if not ab:
        import tempfile

        import torch.distributed as dist

        from autonomous_racing_lpv_mpp_mpc_tpu_torch.engine import build_boxqp, initial_schedule
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import (
            MHEConfig, closed_loop, closed_loop_global, mega_race_sweep, mhe_init, mhe_step,
        )
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import (
            make_mesh, scenario_sharding, sharded_closed_loop, sharded_mega_loop, sharded_race_sweep,
            sharded_solve_step,
        )
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.horizon import horizon_sharded_solve
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.scenarios import (
            _finalize, _local_metrics, checkpointed_sweep, initial_sweep_state, sweep_chunk_fn,
        )
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import admm_solve
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils.record import SweepCheckpoint
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils.tree import tree_map

        t_par = time.perf_counter()
        par = {}

        def driven(label, fn, expected):
            """fn() as a main path: counts reset before, read after; its wall
            seconds and its peak device memory (the peak allocated during
            it, less what earlier phases held when it started)."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return out, {"launches": read_launches(label, expected), "wall_s": wall,
                         "peak_bytes": torch.cuda.max_memory_allocated() - held, "held_bytes": held}

        def fused_held(tag, fcfg, fscfg, fargs):
            """The fused kernel against fused_solve_plain on one prepared step
            from a path's own carry, at the path's shapes; section 5b's
            gates at a fixed count: 2e-4 on lanes converged on both sides,
            5e-3 on every lane, done-at within one iteration."""
            sk = fused_mpc_solve(fcfg, fscfg, *fargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp = fused_solve_plain(fcfg, fscfg, *fargs)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            lane = torch.maximum((sk.U - sp.U).abs().amax(dim=(1, 2)), (sk.X - sp.X).abs().amax(dim=(1, 2)))
            both = sk.converged & sp.converged
            r = {"lanes": lane.numel(), "both": int(both.sum()),
                 "e_conv": lane[both].max().item() if bool(both.any()) else 0.0, "max_abs_err": lane.max().item(),
                 "dda": int((sk.iters - sp.iters).abs().max().item()), "plain_ms": plain_ms,
                 "solve_ms": cuda_time_ms(lambda: fused_mpc_solve(fcfg, fscfg, *fargs), 3)}
            log(f"[{tag}] fused kernel vs plain, one step from the path's carry, B={r['lanes']} N={fcfg.N} "
                f"max_iter={fscfg.max_iter} fixed: converged both {r['both']}/{r['lanes']}: max|dU,dX| "
                f"{r['e_conv']:.3e}; all lanes {r['max_abs_err']:.3e}; done-at max diff {r['dda']}; "
                f"{r['solve_ms']:.3f} ms/solve kernel, {plain_ms:.1f} ms plain ({card})")
            check(not fscfg.early_exit, f"[{tag}] the fused check runs a fixed count")
            check(r["e_conv"] <= 2e-4, f"[{tag}] fused: {r['e_conv']:.3e} beyond 2e-4 of plain (converged lanes)")
            check(r["max_abs_err"] <= 5e-3, f"[{tag}] fused: {r['max_abs_err']:.3e} beyond 5e-3 of plain")
            check(r["dda"] <= 1, f"[{tag}] fused: done-at differs by {r['dda']}")
            return r

        def mega_held(tag, mcfg, mscfg, mtrack, prm, ref, carry, **kw):
            """The megastep against megastep_plain one step from a path's own
            carry, at the path's shapes: u 2e-4 / x 5e-4 (the megastep's
            fixed-count bounds) on lanes converged on both sides, 5e-3 on
            every lane."""
            ck, uk, dk = megastep(mcfg, mscfg, mtrack, prm, ref, carry, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp, up, dp = megastep_plain(mcfg, mscfg, mtrack, prm, ref, carry, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            eu, ex = (uk - up).abs().amax(dim=0), (ck.x - cp.x).abs().amax(dim=0)
            both = (dk[2] > 0.5) & (dp[2] > 0.5)
            r = {"lanes": eu.numel(), "both": int(both.sum()),
                 "du_conv": eu[both].max().item() if bool(both.any()) else 0.0,
                 "dx_conv": ex[both].max().item() if bool(both.any()) else 0.0,
                 "max_abs_err": max(eu.max().item(), ex.max().item()),
                 "dX_pred": (ck.X_pred - cp.X_pred).abs().max().item(),
                 "dda": (dk[4] - dp[4]).abs().max().item(), "plain_ms": plain_ms,
                 "finite": all(bool(torch.isfinite(t).all()) for t in (*ck, uk)),
                 "step_ms": cuda_time_ms(lambda: megastep(mcfg, mscfg, mtrack, prm, ref, carry, **kw), 3)}
            log(f"[{tag}] megastep vs plain, one step from the path's carry, B={r['lanes']} N={mcfg.N}: converged "
                f"both {r['both']}/{r['lanes']}: max|du| {r['du_conv']:.3e} max|dx| {r['dx_conv']:.3e}; all lanes "
                f"{r['max_abs_err']:.3e}; |dX_pred| {r['dX_pred']:.3e}; done-at max diff {r['dda']:.0f}; "
                f"{r['step_ms']:.3f} ms/step kernel, {plain_ms:.1f} ms plain ({card})")
            check(r["finite"], f"[{tag}] megastep: not finite")
            check(r["du_conv"] <= 2e-4 and r["dx_conv"] <= 5e-4,
                  f"[{tag}] megastep: beyond (2e-4, 5e-4) of plain on converged lanes")
            check(r["max_abs_err"] <= 5e-3, f"[{tag}] megastep: {r['max_abs_err']:.3e} beyond 5e-3 of plain")
            return r

        mesh = make_mesh()                  # one rank on the card
        check(dist.get_backend() == "nccl" and mesh.size() == 1,
              f"[config5] the mesh is {dist.get_backend()} over {mesh.size()} ranks, expected NCCL over 1")

        # [config5]: bench/presets.py::config5's sweep at per_device=131072:
        # N=14, the racetrack, a Pacejka plant, the CLI's solver config on
        # the fused route; (b) the same scenarios on the megastep. Gates:
        # lanes 0-4095 bitwise an unsharded run of those lanes alone; each
        # kernel against its plain version one step from the sweep's own
        # carry after CHUNK5 steps, at the full width
        cfg5 = MPCConfig(N=14, model="dynamic")
        scfg5 = SolverConfig(max_iter=60, backend="fused")
        ref5 = constant_refs(cfg5, 1.8)
        scen5 = scenario_sharding(mesh, make_scenario_grid(p, cfg5, n_ey=64, n_mu=B_CONFIG5 // 64, vx0=1.5))
        check(scen5.batch == B_CONFIG5, f"[config5] {scen5.batch} lanes")
        sub5 = tree_map(lambda t: t[:B_MAIN], scen5)
        (log5, m5), run5 = driven("config5-fused", lambda: sharded_closed_loop(
            mesh, scen5, cfg5, scfg5, track, ref5, T=T_CONFIG5, sim_tire="pacejka"), {"fused": T_CONFIG5})
        ref_log = closed_loop(sub5.params, cfg5, scfg5, track, sub5.x0, ref5, T_CONFIG5, sim_tire="pacejka")
        run5.update(ms=run5["wall_s"] / T_CONFIG5 * 1e3, solves_per_s=B_CONFIG5 * T_CONFIG5 / run5["wall_s"],
                    converged=float(m5.converged_frac), ey_rms=float(m5.ey_rms), progress=float(m5.mean_progress),
                    mean_iters=float(m5.mean_iters),
                    bitwise=all(torch.equal(a[:B_MAIN], b.movedim(0, 1)) for a, b in zip(log5, ref_log)),
                    finite=all(bool(torch.isfinite(t.float()).all()) for t in log5))
        # the sweep's carry after CHUNK5 steps: its tracker steps replayed
        # on the logged states, each control equal to the logged one
        car5, x5, replay = mpc_init(scen5.params, cfg5, track, scen5.x0), scen5.x0, True
        for t in range(CHUNK5):
            u5, car5, _ = mpc_step_batched(scen5.params, cfg5, scfg5, track, x5, ref5, car5)
            replay = replay and torch.equal(u5, log5.U[:, t])
            x5 = log5.X[:, t].contiguous()
        check(replay, "[config5] the replayed tracker steps differ from the sweep's")
        Xs, Us, kap, xr, lb, ub, x0a, warm = mpc_prepare_light(scen5.params, cfg5, track, x5, ref5, car5)
        run5["held"] = fused_held("config5", cfg5, scfg5,
                                  (scen5.params, Xs, Us, kap, xr, lb, ub, x0a, warm[0], warm[1], car5.rho))
        del Xs, Us, kap, xr, lb, ub, x0a, warm, car5
        par["config5"] = run5
        (X5m, m5m), run5m = driven("config5-mega", lambda: sharded_mega_loop(
            mesh, scen5, cfg5, scfg5, track, ref5, T=T_CONFIG5, sim_tire="pacejka"), {"megastep": T_CONFIG5})

        def mega_sweep(scn):
            """The megastep sweep unsharded: X (b, T, 6), converged and
            done-at (b, T), the params operand and the carry after CHUNK5 steps."""
            c = megastep_init(scn.params, cfg5, track, scn.x0)
            prm = megastep_params(scn.params, scn.batch)
            xs, cv, it, snap = [], [], [], None
            for t in range(T_CONFIG5):
                snap = c if t == CHUNK5 else snap
                c, _, d = megastep(cfg5, scfg5, track, prm, ref5, c, sim_tire="pacejka")
                xs.append(c.x)
                cv.append(d[2])
                it.append(d[4])
            return torch.stack(xs).permute(2, 0, 1), torch.stack(cv).T, torch.stack(it).T, prm, snap

        X4, *_ = mega_sweep(sub5)
        Xa, cva, ita, prm5, snap5 = mega_sweep(scen5)
        # the mesh-wide metrics against the unsharded traces of every lane
        # (their converged flags and done-at included)
        whole = _finalize(_local_metrics(Xa, cva, ita, 5, 4))
        run5m.update(ms=run5m["wall_s"] / T_CONFIG5 * 1e3, solves_per_s=B_CONFIG5 * T_CONFIG5 / run5m["wall_s"],
                     converged=float(m5m.converged_frac), ey_rms=float(m5m.ey_rms),
                     progress=float(m5m.mean_progress), mean_iters=float(m5m.mean_iters),
                     bitwise=torch.equal(X5m[:B_MAIN], X4) and torch.equal(X5m, Xa)
                     and all(torch.equal(a, b) for a, b in zip(m5m, whole)),
                     finite=bool(torch.isfinite(X5m).all()))
        run5m["held"] = mega_held("config5-mega", cfg5, scfg5, track, prm5, ref5, snap5, sim_tire="pacejka")
        del Xa, cva, ita, snap5
        par["config5-mega"] = run5m
        for label, r in (("fused route (sharded_closed_loop)", run5), ("megastep (sharded_mega_loop)", run5m)):
            log(f"[config5] B={B_CONFIG5} T={T_CONFIG5} N=14 racetrack Pacejka plant, world size 1 NCCL, {label}: "
                f"{r['solves_per_s']:.0f} solves/s, {r['ms']:.3f} ms/step wall, converged {r['converged']:.4f}, "
                f"e_y rms {r['ey_rms']:.4f} m, mean progress {r['progress']:.3f} m, mean iterations "
                f"{r['mean_iters']:.2f}, peak device memory {r['peak_bytes'] / 2**30:.3f} GiB "
                f"({r['peak_bytes'] / B_CONFIG5:.0f} B per lane; {r['held_bytes'] / 2**30:.3f} GiB held before it); "
                f"lanes 0-{B_MAIN - 1} bitwise an unsharded run of those lanes (the megastep: and every lane and "
                f"the metrics bitwise the unsharded run of all lanes): {r['bitwise']}, finite={r['finite']} ({card})")
            check(r["finite"], f"[config5] {label}: non-finite output")
            check(r["converged"] >= 0.9, f"[config5] {label}: converged {r['converged']:.4f} < 0.9")
            check(r["bitwise"], f"[config5] {label}: the sharded run differs from the unsharded one")
        # the checkpointed sweep's chunk at config 5's scale (the JAX
        # package's AOT memory analysis of sweep_chunk_fn): its peak memory
        chunk5 = sweep_chunk_fn(mesh, cfg5, scfg5, track, ref5, CHUNK5, sim_tire="pacejka")
        zeros5 = torch.zeros((B_CONFIG5,), device=dev)
        _, run5c = driven("config5-chunk", lambda: chunk5(
            scen5.x0, scen5.params, mpc_init(scen5.params, cfg5, track, scen5.x0),
            {"conv": zeros5, "ey_sq": zeros5, "iters": zeros5}), {"fused": CHUNK5})
        run5c["ms"] = run5c["wall_s"] / CHUNK5 * 1e3
        par["config5-chunk"] = run5c
        log(f"[config5] sweep_chunk_fn, {CHUNK5} steps at B={B_CONFIG5}: peak device memory "
            f"{run5c['peak_bytes'] / 2**30:.3f} GiB ({run5c['peak_bytes'] / B_CONFIG5:.0f} B per lane), "
            f"{run5c['ms']:.3f} ms/step wall ({card})")
        r = cli_run("config5 fused", {"fused": 10}, "config5", "backend=fused", "per_device=4096", "T=5")
        check(r["devices"] == 1 and r["converged_frac"] > 0.9 and "scaling_efficiency" not in r,
              "[cli] config5 fused: not one device, converged <= 0.9, or an efficiency at world size 1")

        # [sharded]: the entry points at B=4096, world size 1, against the
        # unsharded paths on the same inputs
        (mu_s, Xf_s, m_s), run_sr = driven("sharded-race", lambda: sharded_race_sweep(
            mesh, p, rcfg, scfg, track, table, x0r, T_SHARD, mu_b, mu0=0.85, noise_sigma=SIGMA, seed=11),
            {"racestep": T_SHARD})
        ref_sr = mega_race_sweep(p, rcfg, scfg, track, table, x0r, T_SHARD, mu_b, mu0=0.85, noise_sigma=SIGMA,
                                 seed=11)
        run_sr.update(ms=run_sr["wall_s"] / T_SHARD * 1e3, converged=float(m_s.converged_frac),
                      equal=torch.equal(mu_s, ref_sr.mu_hat) and torch.equal(Xf_s, ref_sr.Xf))
        par["sharded-race"] = run_sr
        sharded_solve_step(mesh, scen, cfg, scfg_admm, track, x_ref)              # warm-up
        (u_s, c_s, d_s), run_ss = driven("sharded-step", lambda: sharded_solve_step(
            mesh, scen, cfg, scfg_admm, track, x_ref), {"admm": 1})
        u_r, c_r, _ = mpc_step_batched(scen.params, cfg, scfg_admm, track, scen.x0, x_ref,
                                       mpc_init(scen.params, cfg, track, scen.x0))
        run_ss.update(ms=run_ss["wall_s"] * 1e3, converged=d_s.converged.float().mean().item(),
                      equal=torch.equal(u_s, u_r) and all(torch.equal(a, b) for a, b in zip(c_s, c_r)))
        par["sharded-step"] = run_ss
        hscfg = SolverConfig(max_iter=30)
        (U_h, conv_h), run_h = driven("sharded-horizon", lambda: horizon_sharded_solve(
            mesh, scen, cfg, hscfg, track, x_ref), {})
        u0h = torch.zeros((B_MAIN, NU), device=dev)
        Xs_h, Us_h = initial_schedule(scen.params, cfg, track, scen.x0, u0h)
        sol_h = admm_solve(build_boxqp(scen.params, cfg, track, scen.x0, u0h, Xs_h, Us_h, x_ref), hscfg)
        run_h.update(ms=run_h["wall_s"] * 1e3, dU=(U_h - sol_h.U).abs().max().item(),
                     conv_equal=torch.equal(conv_h, sol_h.converged), converged=conv_h.float().mean().item())
        par["sharded-horizon"] = run_h
        log(f"[sharded] sharded_race_sweep B={B_MAIN} T={T_SHARD} (path 2's protocol, seed 11): "
            f"{run_sr['ms']:.4f} ms/step wall, converged {run_sr['converged']:.4f}, equal to mega_race_sweep on "
            f"the same carry and seed: {run_sr['equal']} ({card})")
        log(f"[sharded] sharded_solve_step B={B_MAIN} N={N_MAIN} admm route: {run_ss['ms']:.3f} ms wall, "
            f"converged {run_ss['converged']:.4f}, equal to mpc_step_batched: {run_ss['equal']} ({card})")
        log(f"[sharded] horizon_sharded_solve n_h=1 B={B_MAIN} N={N_MAIN} max_iter=30: {run_h['ms']:.1f} ms wall, "
            f"max|U - admm_solve U| {run_h['dU']:.3e}, converged {run_h['converged']:.4f} (flags equal: "
            f"{run_h['conv_equal']}) ({card})")
        check(run_sr["equal"], "[sharded] sharded_race_sweep differs from mega_race_sweep")
        check(run_ss["equal"], "[sharded] sharded_solve_step differs from mpc_step_batched")
        check(run_h["dU"] <= 1e-5, f"[sharded] horizon_sharded_solve beyond 1e-5 of admm_solve ({run_h['dU']:.3e})")

        # [ckpt]: checkpointed_sweep on the bench's fused protocol, killed
        # after its first chunk (the process lives on: the second call
        # resumes from the directory), against an uninterrupted run
        with tempfile.TemporaryDirectory(dir=HERE, prefix=".ckpt-smoke-") as tmp:
            ck_args = (mesh, scen, cfg, fused_fixed, track, x_ref)
            (m_ref, n_ref), run_ck = driven("ckpt", lambda: checkpointed_sweep(
                *ck_args, T_CKPT, os.path.join(tmp, "ref"), save_every=CKPT_EVERY), {"fused": T_CKPT})
            _, n_kill = checkpointed_sweep(*ck_args, CKPT_EVERY, os.path.join(tmp, "kill"), save_every=CKPT_EVERY)
            m_res, n_res = checkpointed_sweep(*ck_args, T_CKPT, os.path.join(tmp, "kill"), save_every=CKPT_EVERY)
            # what a save costs: the sweep's last state, read back from its
            # checkpoint and written again CKPT_SAVES times
            _, state_ck = SweepCheckpoint(os.path.join(tmp, "ref")).restore(initial_sweep_state(scen, cfg, track))
            timing = SweepCheckpoint(os.path.join(tmp, "timing"))
            saves = [timing.save(k, state_ck) for k in range(1, CKPT_SAVES + 1)]
        run_ck.update(ms=run_ck["wall_s"] / T_CKPT * 1e3, steps=(n_ref, n_kill, n_res),
                      bitwise=all(torch.equal(a, b) for a, b in zip(m_res, m_ref)),
                      ckpt_bytes=saves[0][0], save_ms=float(np.mean([sec for _, sec in saves])) * 1e3,
                      converged=float(m_ref.converged_frac))
        par["ckpt"] = run_ck
        log(f"[ckpt] checkpointed_sweep B={B_MAIN} T={T_CKPT} save_every={CKPT_EVERY} fused N={N_MAIN}: steps run "
            f"{run_ck['steps']} (uninterrupted, killed, resumed), resumed metrics bitwise the uninterrupted run's: "
            f"{run_ck['bitwise']}; {run_ck['ckpt_bytes']} B per checkpoint ({run_ck['ckpt_bytes'] / B_MAIN:.0f} B per "
            f"lane), {run_ck['save_ms']:.1f} ms per save (mean of {len(saves)}), {run_ck['ms']:.3f} ms/step wall "
            f"with the saves, converged {run_ck['converged']:.4f} ({card})")
        check(run_ck["steps"] == (T_CKPT, CKPT_EVERY, T_CKPT - CKPT_EVERY), "[ckpt] wrong steps run")
        check(run_ck["bitwise"], "[ckpt] the resumed metrics differ from the uninterrupted run's")

        # [global]: closed_loop_global at B=4096 on the oval, fused route, EKF,
        # tests/test_global_loop.py's noise (one stream per lane)
        gcfg = MPCConfig(N=16, model="dynamic")
        gscfg = SolverConfig(max_iter=40, rho_interval=0, backend="fused")
        x0g = torch.zeros((B_MAIN, 6), device=dev)
        x0g[:, 0] = 1.0
        refg = constant_refs(gcfg, 1.5)
        logg, run_g = driven("global", lambda: closed_loop_global(
            p, gcfg, gscfg, oval, x0g, refg, T=T_GLOBAL, noise_sigma=GLOBAL_SIGMA,
            generator=torch.Generator(device=dev).manual_seed(3), use_ekf=True), {"fused": T_GLOBAL})
        # the fused kernel at these shapes against its plain version, from
        # the loop's carry halfway: its tracker steps replayed on the logged
        # estimates, each control equal to the logged one
        carg, replay = mpc_init(p, gcfg, oval, x0g), True
        for t in range(T_GLOBAL // 2):
            ug, carg, _ = mpc_step_batched(p, gcfg, gscfg, oval, logg.Xf[t], refg, carg)
            replay = replay and torch.equal(ug, logg.U[t])
        check(replay, "[global] the replayed tracker steps differ from the loop's")
        Xs, Us, kap, xr, lb, ub, x0a, warm = mpc_prepare_light(p, gcfg, oval, logg.Xf[T_GLOBAL // 2], refg, carg)
        run_g["held"] = fused_held("global", gcfg, gscfg, (p, Xs, Us, kap, xr, lb, ub, x0a, warm[0], warm[1], carg.rho))
        conv_g = logg.converged.float().mean(dim=0)
        run_g.update(ms=run_g["wall_s"] / T_GLOBAL * 1e3, progress_min=logg.Xf[-1, :, 4].min().item(),
                     ey_max=logg.Xf[..., 5].abs().max().item(), conv_min=conv_g.min().item(),
                     converged=conv_g.mean().item(), finite=all(bool(torch.isfinite(t.float()).all()) for t in logg))
        par["global"] = run_g
        L_oval = float(oval.length)
        log(f"[global] closed_loop_global B={B_MAIN} T={T_GLOBAL} oval N=16 fused + EKF + noise: {run_g['ms']:.3f} "
            f"ms/step wall, least progress {run_g['progress_min']:.3f} m (lap {L_oval:.3f} m), |e_y| max "
            f"{run_g['ey_max']:.4f}, converged {run_g['converged']:.4f} (least lane {run_g['conv_min']:.4f}), "
            f"finite={run_g['finite']} ({card})")
        check(run_g["finite"], "[global] non-finite output")
        check(run_g["progress_min"] > L_oval, "[global] a lane did not complete a lap")
        check(run_g["ey_max"] < 0.2, f"[global] |e_y| max {run_g['ey_max']:.4f} >= 0.2")
        check(run_g["conv_min"] > 0.9, f"[global] a lane converged on {run_g['conv_min']:.4f} <= 0.9 of its steps")

        # [mhe]: mhe_step over B=4096 noisy trajectories of tests/test_mhe.py's
        # noisy protocol; lanes 0-15 again on the CPU
        mcfg, mpc12 = MHEConfig(W=8, n_gn=2), MPCConfig(N=12, model="dynamic")
        tt = torch.arange(T_MHE, dtype=torch.float32, device=dev)
        Um = torch.stack([0.08 * torch.sin(2 * np.pi * tt / 40.0), 0.3 + 0.2 * torch.cos(2 * np.pi * tt / 60.0)], 1)
        x0m = torch.tensor([1.2, 0.0, 0.0, 0.0, 0.0, 0.05], device=dev).expand(B_MAIN, 6).contiguous()
        xm, Xm = x0m, []
        for k in range(T_MHE):
            xm = plant_step(p, mpc12, oval, xm, Um[k].expand(B_MAIN, 2), n_sub=4)
            Xm.append(xm)
        Xm = torch.stack(Xm)                                             # (T, B, 6) truth
        sig_m = torch.tensor(MHE_SIGMA, device=dev)
        Zm = Xm + sig_m * torch.randn(Xm.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        eye6 = torch.eye(6, device=dev)
        mats = (0.1 * eye6, eye6, 1e-4 * eye6, torch.diag(sig_m ** 2))   # P0, H, Qw, Rv

        def mhe_run(track_m, Z, U, x0, mats_m):
            st = mhe_init(mpc12, mcfg, x0, mats_m[1])
            out = []
            for k in range(T_MHE):
                st, xh = mhe_step(p, mpc12, mcfg, track_m, st, U[k].expand(x0.shape[0], 2), Z[k], *mats_m)
                out.append(xh)
            return torch.stack(out)

        Xh, run_m = driven("mhe", lambda: mhe_run(oval, Zm, Um, x0m, mats), {})
        w = mcfg.W
        rmse = lambda A: (A[w:] - Xm[w:]).pow(2).mean().sqrt().item()
        cpu = lambda t: t.cpu()
        t0 = time.perf_counter()
        Xh_cpu = mhe_run(oval_track(device="cpu"), cpu(Zm[:, :MHE_CPU_LANES]), cpu(Um), cpu(x0m[:MHE_CPU_LANES]),
                         tuple(cpu(t) for t in mats))
        cpu_ms = (time.perf_counter() - t0) / T_MHE * 1e3
        run_m.update(ms=run_m["wall_s"] / T_MHE * 1e3, rmse_mhe=rmse(Xh), rmse_meas=rmse(Zm), cpu_ms=cpu_ms,
                     card_vs_cpu=(Xh[:, :MHE_CPU_LANES].cpu() - Xh_cpu).abs().max().item(),
                     finite=bool(torch.isfinite(Xh).all()))
        par["mhe"] = run_m
        log(f"[mhe] mhe_step B={B_MAIN} T={T_MHE} W={mcfg.W} n_gn={mcfg.n_gn}: {run_m['ms']:.3f} ms/step wall on the "
            f"card, {run_m['cpu_ms']:.3f} ms/step on the CPU for lanes 0-{MHE_CPU_LANES - 1}; rmse {run_m['rmse_mhe']:.5f} "
            f"against the sensor's {run_m['rmse_meas']:.5f} ({run_m['rmse_mhe'] / run_m['rmse_meas']:.3f}), card vs "
            f"CPU on lanes 0-{MHE_CPU_LANES - 1} {run_m['card_vs_cpu']:.3e}, finite={run_m['finite']} ({card})")
        check(run_m["finite"], "[mhe] non-finite estimate")
        check(run_m["rmse_mhe"] < 0.6 * run_m["rmse_meas"], "[mhe] the estimate does not beat 0.6 x the sensor")
        check(run_m["card_vs_cpu"] <= 1e-3, f"[mhe] card and CPU apart by {run_m['card_vs_cpu']:.3e} > 1e-3")
        log(f"[parallel] phases wall {time.perf_counter() - t_par:.1f} s ({card})")

    # ---- 17-19. the last slice, each path driven with the counts set to 0
    # just before it and read just after: [utils] the profiling and debug
    # tools, [pipelined] replanning with the planner on a second stream,
    # [realtime] the deployment loop over the native IO bridge ----
    pipe = rt = utl = None
    if not ab:
        import tempfile

        from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPPConfig
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.io import BridgeUnavailable, CarBridge, realtime_tracking_loop
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import closed_loop, ekf_init, ekf_step, mpc_step
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import (
            online as online_mod, pipelined_replanning_loop, replanning_loop,
        )
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import (
            checked_closed_loop, enable_nan_debugging, timed, trace_to,
        )
        from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils.nativelib import find_native_lib

        t_new = time.perf_counter()

        def fused_device_ms(fcfg, fscfg, fargs):
            """One fused solve's own device time (torch.profiler) at these operands."""
            return kernel_ms(lambda: fused_mpc_solve(fcfg, fscfg, *fargs), 10, "fused_kernel")

        def one_car_fargs(fcfg, ftrack, x, ref, carry, obs=None):
            """The fused solve's operands of one car's step (batch of one)."""
            cb = MPCCarry(*(t[None] for t in carry))
            Xs, Us, kap, xr, lb, ub, x0a, warm = mpc_prepare_light(p, fcfg, ftrack, x[None], ref, cb, obs)
            return (p, Xs, Us, kap, xr, lb, ub, x0a, warm[0], warm[1], cb.rho)

        # [utils]: timed, trace_to, the NaN mode and
        # checked_closed_loop on the card; one megastep launch at cell 1's
        # shape. The trace is taken in a fresh process that loads the built
        # kernel library before its first profiler session: in this
        # long-lived one, sessions have lost their first kernel records
        # (PERF.md §6, PR 11 after review), and trace_to raises on a trace
        # without them
        car_u = megastep_init(scen.params, cfg, track, scen.x0)
        mstep = lambda c: megastep(cfg, scfg, track, prm, x_ref, c, n_sub=4)
        ckcfg = SolverConfig(max_iter=40, backend="fused")

        def utils_phase():
            u = {}
            secs, _ = timed(mstep, car_u, warmup=1, iters=5)
            ev = []
            for _ in range(5):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                e0.record()
                mstep(car_u)
                e1.record()
                torch.cuda.synchronize()
                ev.append(e0.elapsed_time(e1))
            u.update(timed_ms=secs * 1e3, events_ms=min(ev))
            with tempfile.TemporaryDirectory() as tdir:
                child = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--trace-megastep", tdir],
                                       capture_output=True, text=True, timeout=300)
            check(child.returncode == 0, f"[utils] the trace process failed: {child.stderr[-2000:]}")
            traced = json.loads(child.stdout.strip().splitlines()[-1])
            u.update(trace_kernels=traced["kernels"], trace_launches=traced["launches"])
            enable_nan_debugging()
            try:
                try:
                    torch.sqrt(torch.tensor([-1.0], device=dev))
                    u["nan_raised"] = None
                except FloatingPointError as e:
                    u["nan_raised"] = str(e)
                mstep(car_u)           # a normal step: raises nothing
            finally:
                enable_nan_debugging(False)
            kx0 = torch.tensor([0.5, 0.0, 0.0, 0.0], device=dev)
            err_ok, _ = checked_closed_loop(p, kcfg, ckcfg, oval, kx0, constant_refs(kcfg, 1.2), T=30)
            err_bad, _ = checked_closed_loop(p, kcfg, ckcfg, oval, torch.tensor([0.5, 0.0, 0.0, 25.0], device=dev),
                                             constant_refs(kcfg, 1.2), T=30, ey_limit=1.0)
            u.update(check_ok=err_ok.get(), check_bad=err_bad.get())
            return u

        # timed's 6, the events' 5, the NaN mode's 1 (the trace process
        # counts its own 2)
        utl, run_u = driven("utils", utils_phase, {"megastep": 12, "fused": 60})
        utl.update(run_u)
        log(f"[utils] timed {utl['timed_ms']:.4f} ms against CUDA events {utl['events_ms']:.4f} ms per cell-1 "
            f"megastep; trace_to's kernels {utl['trace_kernels']} ({utl['trace_launches']} megastep launches in the trace "
            f"process); NaN mode: {utl['nan_raised']!r}; checked_closed_loop sane "
            f"{utl['check_ok']!r}, e_y=25 {utl['check_bad']!r} ({card})")
        check(abs(utl["timed_ms"] - utl["events_ms"]) <= 0.2 * utl["events_ms"],
              "[utils] timed is not within 20% of CUDA events")
        check(any("megastep_kernel" in k for k in utl["trace_kernels"]), "[utils] the trace names no megastep_kernel")
        check(utl["nan_raised"] is not None and "sqrt" in utl["nan_raised"], "[utils] the NaN mode did not raise")
        check(utl["check_ok"] is None and utl["check_bad"] is not None, "[utils] checked_closed_loop misjudged")

        # [pipelined]: tests/test_planner.py:147-185 at its size, the tracker on
        # the fused kernel; the serial loop first (plans and segments timed
        # between syncs), then the pipelined loop, then the pipelined loop
        # again under the port's trace_to
        pcfg_t = MPCConfig(N=16, model="dynamic")
        # the JAX test's tracker runs 60 iterations with rho adapted every 20;
        # the fused kernel adapts rho once per solve, so at 60 it terminates
        # formally on fewer steps (the run at 60 below is reported, not
        # gated) and the gated runs give it PIPE_ITERS. JAX's own loop on
        # the once-per-solve schedule converges on the same share as the
        # port's fused route (tests/test_torch_online.py::
        # test_fused_tracker_at_60_iterations_follows_the_rho_schedule)
        pscfg = SolverConfig(max_iter=PIPE_ITERS, rho_interval=0, backend="fused")
        ppcfg = MPPConfig(H=PIPE_H, n_sqp=2)
        x0p = torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], device=dev)
        blk = np.array([[4.0, 5.0, -0.4, 0.1]], np.float32)
        pargs = (p, pcfg_t, pscfg, ppcfg, oval, x0p, T_PIPE)
        pkw = dict(replan_every=REPLAN_EVERY, obstacles_fn=lambda t: blk if t >= REPLAN_EVERY else None)
        orig_plan, orig_seg = online_mod.plan_mpp, online_mod._track_segment
        split = {"plan": [], "segment": []}

        def synced(key, fn):
            def f(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                split[key].append(time.perf_counter() - t0)
                return out
            return f

        online_mod.plan_mpp = synced("plan", orig_plan)
        online_mod._track_segment = lambda *a: synced("segment", orig_seg(*a))
        try:
            res_s, run_s = driven("pipelined-serial", lambda: replanning_loop(*pargs, **pkw), {"fused": T_PIPE})
        finally:
            online_mod.plan_mpp, online_mod._track_segment = orig_plan, orig_seg
        res_60, run_60 = driven("pipelined-serial-60", lambda: replanning_loop(
            p, pcfg_t, pscfg.replace(max_iter=60), ppcfg, oval, x0p, T_PIPE, **pkw), {"fused": T_PIPE})
        seg_in = []     # the pipelined run's segment inputs (x, carry, table, blocks): references only

        def recording(*a):
            run = orig_seg(*a)

            def f(x, carry, table, obstacles=None):
                seg_in.append((x, carry, table, obstacles))
                return run(x, carry, table, obstacles)
            return f

        online_mod._track_segment = recording
        try:
            res_p, run_p = driven("pipelined", lambda: pipelined_replanning_loop(*pargs, **pkw), {"fused": T_PIPE})
        finally:
            online_mod._track_segment = orig_seg
        # the trace: trace_to over a third pipelined run, from just before
        # the plan for segment 2 is issued (its thread is born inside the
        # session: a planner thread born before it was seen to leave no
        # kernel records) over TRACE_STEPS tracker steps of segment 1; the
        # window's exit synchronises the card, so this run's wall is not
        # the pipelined one's
        import autonomous_racing_lpv_mpp_mpc_tpu_torch.loop.mpc as mpc_mod
        orig_step, window = mpc_mod.mpc_step, {"k": 0}

        def windowed_obstacles(t):
            if t == 2 * REPLAN_EVERY and "cm" not in window:     # the plan for segment 2 is issued next
                window["cm"] = trace_to(tdir)
                window["tr"], window["t0"] = window["cm"].__enter__(), time.perf_counter()
            return pkw["obstacles_fn"](t)

        def windowed_step(*a, **k):
            out = orig_step(*a, **k)
            window["k"] += 1
            if window["k"] == REPLAN_EVERY + TRACE_STEPS:
                window["cm"].__exit__(None, None, None)
                window["s"] = time.perf_counter() - window["t0"]
            return out

        with tempfile.TemporaryDirectory() as tdir:
            mpc_mod.mpc_step = windowed_step
            try:
                res_tr, run_tr = driven("pipelined-traced", lambda: pipelined_replanning_loop(
                    *pargs, replan_every=REPLAN_EVERY, obstacles_fn=windowed_obstacles), {"fused": T_PIPE})
            finally:
                mpc_mod.mpc_step = orig_step
            check("s" in window, "[pipelined] the traced window did not close")
            t0 = time.perf_counter()
            trace_mb = os.path.getsize(window["tr"].path) / 2 ** 20
            with open(window["tr"].path) as f:
                kern = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel" and e.get("ph") == "X"]
            trace_s, traced_seg_s = time.perf_counter() - t0, window["s"]
        # the tracker's stream is the one the fused kernel ran on; the
        # planner's is every other stream with kernels after the first plan
        t_stream = {e["args"]["stream"] for e in kern if "fused_kernel" in e["name"]}
        check(len(t_stream) == 1, f"[pipelined] the fused kernel ran on streams {t_stream}")
        t_iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern if e["args"]["stream"] in t_stream)
        union = []
        for a, b in t_iv:
            if union and a <= union[-1][1]:
                union[-1][1] = max(union[-1][1], b)
            else:
                union.append([a, b])
        starts = [u[0] for u in union]
        p_kern = [e for e in kern if e["args"]["stream"] not in t_stream]
        p_busy = sum(e["dur"] for e in p_kern)
        p_over = 0.0
        for e in p_kern:
            a, b = e["ts"], e["ts"] + e["dur"]
            i = max(0, bisect.bisect_right(starts, a) - 1)
            while i < len(union) and union[i][0] < b:
                p_over += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
                i += 1
        X_s, X_p = res_s.log.X.cpu().numpy(), res_p.log.X.cpu().numpy()
        L_oval = float(oval.length)

        def jax_checks(res):
            X = res.log.X.cpu().numpy()
            s_mod = X[:, 4] % L_oval
            mask = (np.arange(X.shape[0]) > 80) & (s_mod > 4.3) & (s_mod < 4.7)
            return {"s_end": float(X[-1, 4]), "converged": res.log.converged.float().mean().item(),
                    "ey_past_block": float(X[mask, 5].min()) if mask.any() else float("nan"),
                    "finite": bool(np.isfinite(X).all())}

        # the boundary predictor on the card against the same call on CPU
        # copies, at segment 2's start state and table
        x2, car2, tab2, obs2 = seg_in[2]
        predict = online_mod._boundary_predictor(pcfg_t, REPLAN_EVERY)
        pred_err = (predict(tab2, x2).cpu() - predict(tab2.to("cpu"), x2.cpu())).abs().max().item()
        # the fused kernel at this path's shape, one solve from the loop's
        # carry at step 120
        fargs_p = one_car_fargs(pcfg_t, oval, x2, tab2, car2, obs2)
        held_p = fused_held("pipelined", pcfg_t, pscfg, fargs_p)
        held_p["device_ms"] = fused_device_ms(pcfg_t, pscfg, fargs_p)
        # and at the JAX test's 60 iterations (the reported serial run's count)
        held_p60 = fused_held("pipelined-60", pcfg_t, pscfg.replace(max_iter=60), fargs_p)
        seg_s, plan_s = split["segment"], split["plan"]
        n_seg = len(seg_s)
        # the prediction from the serial run's own times; the first plan of
        # the pipelined run replays graphs the serial run captured
        plan0 = float(np.median(plan_s[1:]))
        predicted = plan0 + sum(max(seg_s[k], plan_s[k + 1]) for k in range(n_seg - 1)) + seg_s[-1]
        pipe = {"launches": {"serial": run_s["launches"]["fused"], "serial-60": run_60["launches"]["fused"],
                             "pipelined": run_p["launches"]["fused"], "traced": run_tr["launches"]["fused"]},
                "wall_serial_s": run_s["wall_s"], "wall_pipelined_s": run_p["wall_s"],
                "wall_traced_s": run_tr["wall_s"], "predicted_s": predicted,
                "saving_max_s": sum(min(seg_s[k], plan_s[k + 1]) for k in range(n_seg - 1)),
                "plan_s": plan_s, "segment_s": seg_s, "overlap_share": p_over / max(p_busy, 1e-9),
                "planner_device_ms": p_busy / 1e3, "planner_streams": len({e["args"]["stream"] for e in p_kern}),
                "trace_mb": trace_mb, "trace_s": trace_s, "traced_window_s": traced_seg_s, "pred_err": pred_err,
                "held": held_p, "held_60": held_p60,
                "jax": {"serial": jax_checks(res_s), "pipelined": jax_checks(res_p)},
                "jax_60": jax_checks(res_60),
                "first_segment_bitwise": all(torch.equal(a[:REPLAN_EVERY], b[:REPLAN_EVERY])
                                             for a, b in zip(res_s.log, res_p.log)),
                "replans": (res_s.replan_steps.tolist(), res_p.replan_steps.tolist(),
                            res_tr.replan_steps.tolist()),
                "max_dx": float(np.abs(X_s - X_p).max())}
        log(f"[pipelined] oval N=16 fused ({PIPE_ITERS} fixed iterations), H={PIPE_H} n_sqp=2, T={T_PIPE}, a replan every {REPLAN_EVERY}: serial "
            f"{pipe['wall_serial_s']:.3f} s (plans {', '.join(f'{t:.3f}' for t in plan_s)} s; segments "
            f"{', '.join(f'{t:.3f}' for t in seg_s)} s), pipelined {pipe['wall_pipelined_s']:.3f} s against "
            f"plan_0 + sum max(segment_k, plan_k+1) + last segment = {predicted:.3f} s (at most "
            f"{pipe['saving_max_s']:.3f} s can be hidden: each plan outlasts its segment), traced "
            f"{pipe['wall_traced_s']:.3f} s ({card})")
        log(f"[pipelined] trace from the plan for segment 2's issue over tracker steps {REPLAN_EVERY}-"
            f"{REPLAN_EVERY + TRACE_STEPS - 1} ({trace_mb:.1f} MB, trace_to; the window with the trace's export "
            f"{traced_seg_s:.2f} s, read in {trace_s:.2f} s): the planner's {len(p_kern)} kernels on "
            f"{pipe['planner_streams']} stream(s), {pipe['planner_device_ms']:.1f} ms of device time, overlap the "
            f"tracker stream's kernels for {pipe['overlap_share']:.4f} of it; replan steps {pipe['replans']}; "
            f"first segment bitwise equal: {pipe['first_segment_bitwise']}; serial vs pipelined max |dX| "
            f"{pipe['max_dx']:.3e}; predictor card vs CPU {pred_err:.3e}; fused device {held_p['device_ms']:.4f} ms "
            f"at B=1 N=16; JAX checks {pipe['jax']}; the serial loop at the JAX test's 60 iterations (reported): "
            f"{pipe['jax_60']}")
        for tag, jc in pipe["jax"].items():
            check(jc["finite"], f"[pipelined] {tag}: non-finite states")
            check(jc["s_end"] > 1.5 * L_oval, f"[pipelined] {tag}: s at the end {jc['s_end']:.3f} <= 1.5 laps")
            check(jc["converged"] > 0.85, f"[pipelined] {tag}: converged {jc['converged']:.4f} <= 0.85")
            check(jc["ey_past_block"] > 0.1, f"[pipelined] {tag}: e_y past the block {jc['ey_past_block']:.4f} <= 0.1")
        want_steps = list(range(0, T_PIPE, REPLAN_EVERY))
        check(all(r == want_steps for r in pipe["replans"]), f"[pipelined] replan steps {pipe['replans']}")
        check(pipe["first_segment_bitwise"], "[pipelined] the first segment differs between serial and pipelined")
        check(pred_err <= 1e-5, f"[pipelined] the predictor's card and CPU results differ by {pred_err:.3e}")
        check(pipe["overlap_share"] > 0.0, "[pipelined] the planner's kernels never overlapped the tracker's")

        # [realtime]: the deployment loop over the shm bridge; the car is
        # tests/_torch_car_worker.py in a child process (the port only, its
        # plant on the CPU), the controller this process on the card
        t0 = time.perf_counter()
        find_native_lib("libiobridge.so", "libiobridge.so")     # raises if it cannot be built
        bridge_s = time.perf_counter() - t0
        sys.path.insert(0, os.path.join(HERE, "tests"))
        from _torch_car_worker import NOISE_SIGMA, X0 as CAR_X0

        def hil(tag, extra, loop_args, **loop_kw):
            """(the car's JSON result, RealtimeLog) of T_RT lockstep frames."""
            name = f"/arl_smoke_{tag}_{os.getpid()}"
            child = subprocess.Popen([sys.executable, os.path.join(HERE, "tests", "_torch_car_worker.py"), name,
                                      str(T_RT), "shm", *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)
            try:
                t_end = time.monotonic() + 120.0
                while True:
                    try:
                        br = CarBridge(name)
                        break
                    except BridgeUnavailable:
                        if child.poll() is not None:
                            fail(f"[realtime] the car process ended: {child.communicate()[1][-2000:]}")
                        check(time.monotonic() < t_end, f"[realtime] the car's bridge {name} never appeared")
                        time.sleep(0.05)
                try:
                    rlog = realtime_tracking_loop(*loop_args, br, T_RT, **loop_kw)
                finally:
                    br.close()
                out, err = child.communicate(timeout=300)
                check(child.returncode == 0, f"[realtime] the car process failed: {err[-2000:]}")
            finally:
                if child.poll() is None:
                    child.kill()
                    child.communicate()
            return json.loads(out.strip().splitlines()[-1]), rlog

        def replay_carry(rcfg, rscfg, rtrack, ref, rlog, k_end):
            """The loop's carry after k_end frames, from mpc_init on the first
            raw frame and one mpc_step per state fed to the MPC, and whether
            each replayed control equals the logged one."""
            fr, U = torch.as_tensor(rlog.X_est, device=dev), rlog.U
            c, same = mpc_init(p, rcfg, rtrack, torch.as_tensor(rlog.X[0], device=dev)), True
            for k in range(k_end):
                u, c, _ = mpc_step(p, rcfg, rscfg, rtrack, fr[k], ref, c)
                same = same and bool(np.array_equal(u.cpu().numpy(), U[k]))
            return fr[k_end], c, same

        def rt_stats(rlog):
            ms = np.sort(rlog.solve_s.astype(np.float64)) * 1e3
            return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
                    "max_ms": float(ms[-1]), "missed": int(rlog.missed.sum()),
                    "frames_ok": bool(np.array_equal(rlog.frame_counts, np.arange(1, T_RT + 1))),
                    "converged": float(np.mean(rlog.converged))}

        rt = {"bridge_build_s": bridge_s}
        # (a) the noise-free lockstep car: cell 3's tracker for one car on the racetrack
        cfg_a = MPCConfig(N=N_MAIN, model="dynamic")
        scfg_a = SolverConfig(max_iter=20, rho_interval=0, early_exit=False, check_termination=2, backend="fused")
        ref_a = constant_refs(cfg_a, 1.8)
        (res_a, log_a), run_a = driven("realtime-lockstep", lambda: hil(
            "rta", ["clean", "racetrack"], (p, cfg_a, scfg_a, track, ref_a)), {"fused": T_RT + 1})
        ref_loop = closed_loop(p, cfg_a, scfg_a, track, torch.tensor(CAR_X0, device=dev), ref_a, T=T_RT)
        xa, ca, same_a = replay_carry(cfg_a, scfg_a, track, ref_a, log_a, T_RT // 2)
        fargs_a = one_car_fargs(cfg_a, track, xa, ref_a, ca)
        held_a = fused_held("realtime-lockstep", cfg_a, scfg_a, fargs_a)
        held_a["device_ms"] = fused_device_ms(cfg_a, scfg_a, fargs_a)
        rt["lockstep"] = {**rt_stats(log_a), **run_a, "held": held_a, "replay_equal": same_a,
                          "dx_final": float(np.abs(np.asarray(res_a["x_final"]) - ref_loop.X[-1].cpu().numpy()).max()),
                          "dU": float(np.abs(log_a.U - ref_loop.U.cpu().numpy()).max())}
        # (b) the noisy, glitchy car of tests/_car_worker.py on the JAX test's
        # controller with the EKF in the chain
        cfg_b = MPCConfig(N=10, model="dynamic")
        scfg_b = SolverConfig(max_iter=30, rho_interval=0, backend="fused")
        ref_b = constant_refs(cfg_b, 1.5)
        (res_b, log_b), run_b = driven("realtime-ekf", lambda: hil(
            "rtb", ["noise", "oval"], (p, cfg_b, scfg_b, oval, ref_b), use_ekf=True,
            ekf_r=np.asarray(NOISE_SIGMA) ** 2), {"fused": T_RT + 1})
        # the graphed filter against the eager ekf_step on the run's first
        # K_EKF_EAGER raw frames and published controls
        e_x = ekf_init(torch.as_tensor(log_b.X[0], device=dev)[None])
        Qn = torch.diag(torch.tensor(DEFAULT_EKF_Q, device=dev))
        Rn = torch.diag(torch.tensor(np.asarray(NOISE_SIGMA) ** 2, dtype=torch.float32, device=dev))
        u_prev, ekf_gap = torch.zeros(2, device=dev), 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(K_EKF_EAGER):
            e_x = ekf_step(p, cfg_b, oval, e_x, u_prev[None], torch.as_tensor(log_b.X[k], device=dev)[None], Qn, Rn,
                           gate_sigma=3.0)
            ekf_gap = max(ekf_gap, float(np.abs(e_x.x[0].cpu().numpy() - log_b.X_est[k]).max()))
            u_prev = torch.as_tensor(log_b.U[k], device=dev)
        eager_ekf_ms = (time.perf_counter() - t0) / K_EKF_EAGER * 1e3
        truth = np.asarray(res_b["traj_true"], np.float32)[: T_RT - 1]
        rms = lambda a, i: float(np.sqrt(np.mean((a[1:, i] - truth[:, i]) ** 2)))
        xb, cb_, same_b = replay_carry(cfg_b, scfg_b, oval, ref_b, log_b, T_RT // 2)
        fargs_b = one_car_fargs(cfg_b, oval, xb, ref_b, cb_)
        held_b = fused_held("realtime-ekf", cfg_b, scfg_b, fargs_b)
        held_b["device_ms"] = fused_device_ms(cfg_b, scfg_b, fargs_b)
        rt["ekf"] = {**rt_stats(log_b), **run_b, "held": held_b, "replay_equal": same_b,
                     "vx_end": res_b["x_final"][0], "graphed_vs_eager": ekf_gap, "eager_ekf_ms": eager_ekf_ms, "ey_rms_true": res_b["ey_rms_true"],
                     "est_rms": {i: (rms(log_b.X_est, i), rms(log_b.X, i)) for i in (3, 5)}}
        for tag in ("lockstep", "ekf"):
            r = rt[tag]
            log(f"[realtime] {tag}: {T_RT} frames over the shm bridge, solve_s p50 {r['p50_ms']:.3f} ms, p99 "
                f"{r['p99_ms']:.3f} ms, max {r['max_ms']:.3f} ms, {r['missed']} deadline misses at 30 Hz, fused "
                f"kernel {r['held']['device_ms']:.4f} ms device / {r['held']['solve_ms']:.4f} ms events per B=1 "
                f"solve; frames 1..T {r['frames_ok']}, converged {r['converged']:.4f}, replayed controls equal "
                f"{r['replay_equal']}, wall {r['wall_s']:.2f} s ({card})")
            check(r["frames_ok"], f"[realtime] {tag}: frame counts are not 1..{T_RT}")
            check(r["replay_equal"], f"[realtime] {tag}: the replayed controls differ from the loop's")
            check(r["p50_ms"] < 1e3 / 30, f"[realtime] {tag}: median solve {r['p50_ms']:.3f} ms >= 1/30 s")
        ra, rb = rt["lockstep"], rt["ekf"]
        log(f"[realtime] lockstep against the in-process closed_loop on the card: |dx_final| {ra['dx_final']:.3e}, "
            f"max |dU| {ra['dU']:.3e}; ekf: vx at the end {rb['vx_end']:.4f}, true e_y rms {rb['ey_rms_true']:.4f}, "
            f"estimate rms (EKF, raw frames) e_psi {rb['est_rms'][3]}, e_y {rb['est_rms'][5]}; the graphed EKF against "
            f"the eager step over {K_EKF_EAGER} frames {rb['graphed_vs_eager']:.3e} (the eager step "
            f"{rb['eager_ekf_ms']:.2f} ms with its host reads); bridge built in "
            f"{bridge_s:.2f} s")
        check(ra["dx_final"] <= 1e-3 and ra["dU"] <= 1e-3, "[realtime] lockstep: beyond 1e-3 of closed_loop")
        check(rb["graphed_vs_eager"] <= 1e-6, f"[realtime] ekf: the graphed filter is {rb['graphed_vs_eager']:.3e} "
              "from the eager step")
        check(rb["vx_end"] > 1.2, f"[realtime] ekf: vx at the end {rb['vx_end']:.4f} <= 1.2")
        check(rb["ey_rms_true"] < 0.12, f"[realtime] ekf: true e_y rms {rb['ey_rms_true']:.4f} >= 0.12")
        for i, (e_ekf, e_raw) in rb["est_rms"].items():
            check(e_ekf < 0.5 * e_raw, f"[realtime] ekf: channel {i} estimate rms {e_ekf:.4f} >= 0.5 x raw {e_raw:.4f}")

        log(f"[last-slice] phases wall {time.perf_counter() - t_new:.1f} s ({card})")

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
    if mega_cache is not None:
        # [mega-cache]: the cached instantiation at the measured reuse share
        # (a reusing group builds one stage of N), the drift, what it needs
        # of the old cache at that share, and the new cache written
        it["megastep_kernel cached"] = mega_cache["iters"]
        builds = N_MAIN * (1.0 - mega_cache["reuse"]) + mega_cache["reuse"]
        per_lane["megastep_kernel cached"] = (
            core_ops(S_dyn, cfg.tire, N_MAIN, it["megastep_kernel cached"], builds=builds)
            + cache_drift_ops(6, N_MAIN) + plant_ops(S_dyn, cfg.tire, 4),
            mega_bytes(6, N_MAIN) + 4 * (cache_read_floats(6, N_MAIN, mega_cache["reuse"])
                                         + cache_floats(6, N_MAIN)))
        shared["megastep_kernel cached"] = shared["megastep_kernel"]
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
    if lap9 is not None:
        # path 7b: path 7's instantiation on the oval (its measurement window)
        win7b = min(2 * _win_cells(oval7, 3.0) + 1, oval7.n_cells)
        it["racestep_kernel n12 B=1 oval"] = scfg7.max_iter
        per_lane["racestep_kernel n12 B=1 oval"] = (race_ops(S_race12, N_RACE, scfg7.max_iter, 4, 10, win7b,
                                                             gate=False), race_bytes(N_RACE))
        shared["racestep_kernel n12 B=1 oval"] = 4 * (4 * oval7.n_cells + 3 * log7b.tables_vx.shape[-1] + 16)
        lanes["racestep_kernel n12 B=1 oval"] = 1
        # path 8: the racestep at N=12 with per-lane tables, B_LEARN cars
        it["racestep_kernel n12 per-lane"] = executed_iters(torch.stack(done8))
        per_lane["racestep_kernel n12 per-lane"] = (
            race_ops(S_race12, N_RACE, it["racestep_kernel n12 per-lane"], 4, 10, win, gate=False),
            race_bytes(N_RACE, per_lane=True))
        shared["racestep_kernel n12 per-lane"] = 4 * (4 * track.n_cells + 16)
        lanes["racestep_kernel n12 per-lane"] = B_LEARN
        # path 9: the megastep at N=10 with the Pacejka tyre, 10 plant
        # sub-steps, per-lane references
        S_lap = model_structure(p, lcfg, scfg9)
        it["megastep_kernel pacejka n10"] = executed_iters(torch.stack(done9))
        per_lane["megastep_kernel pacejka n10"] = (core_ops(S_lap, lcfg.tire, N_LAP, it["megastep_kernel pacejka n10"])
                                                   + plant_ops(S_lap, lcfg.tire, 10), mega_bytes(6, N_LAP))
        shared["megastep_kernel pacejka n10"] = 4 * loval.n_cells
    if par is not None:
        # [config5]: the fused kernel and the megastep at N=14, B=131072, a
        # fixed count of max_iter (no early exit; one factorization per
        # solve: the kernels take no rho interval), the megastep's Pacejka
        # plant at 4 sub-steps; [global]: the fused kernel at N=16 on the
        # oval, a fixed 40. [ckpt], [sharded-race] and [sharded-step] run the
        # shapes of main paths 3, 2 and the solver-only check: their bounds
        S5 = model_structure(p, cfg5, scfg5)
        it["fused_kernel config5"] = it["megastep_kernel config5"] = scfg5.max_iter
        per_lane["fused_kernel config5"] = (fused_ops(S5, cfg5.tire, cfg5.N, scfg5.max_iter), fused_bytes(6, cfg5.N))
        per_lane["megastep_kernel config5"] = (core_ops(S5, cfg5.tire, cfg5.N, scfg5.max_iter)
                                               + plant_ops(S5, "pacejka", 4), mega_bytes(6, cfg5.N))
        shared["megastep_kernel config5"] = 4 * track.n_cells
        lanes["fused_kernel config5"] = lanes["megastep_kernel config5"] = B_CONFIG5
        Sg = model_structure(p, gcfg, gscfg)
        it["fused_kernel global"] = gscfg.max_iter
        per_lane["fused_kernel global"] = (fused_ops(Sg, gcfg.tire, gcfg.N, gscfg.max_iter), fused_bytes(6, gcfg.N))
    if pipe is not None:
        # [pipelined] and [realtime]: the fused kernel at B=1 and a fixed count
        # of max_iter (no early exit), at each path's N
        for key, (fcfg, fscfg) in {"fused_kernel pipelined": (pcfg_t, pscfg),
                                   "fused_kernel realtime-lockstep": (cfg_a, scfg_a),
                                   "fused_kernel realtime-ekf": (cfg_b, scfg_b)}.items():
            it[key] = fscfg.max_iter
            per_lane[key] = (fused_ops(model_structure(p, fcfg, fscfg), fcfg.tire, fcfg.N, fscfg.max_iter),
                             fused_bytes(6, fcfg.N))
            lanes[key] = 1
    bounds = {k: bound(lanes.get(k, B_MAIN) * o, lanes.get(k, B_MAIN) * b + shared.get(k, 0))
              for k, (o, b) in per_lane.items()}
    log("[bound] per launch on the H100 at B=4096 unless named (67 TFLOP/s f32, 3.35 TB/s): " + "; ".join(
        f"{k} {bounds[k][0]:.4g} ms ({bounds[k][1]}: {per_lane[k][0]:,.0f} operations and "
        f"{per_lane[k][1]:,.0f} B per lane at {it[k]:.2f} executed iterations)" for k in per_lane))

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
    ] + ([] if mega_cache is None else [
        ("megastep_kernel cached", f"{src}/megastep_cache_kernel.cu + {src}/megastep_kernel.cu + {gcore}",
         "megastep_kernel.py:1081",
         mega_cache["launches"], mega_cache["max_abs_err"], mega_cache["ms"], mega_cache["device_ms"],
         mega_cache["plain_ms"]),
    ])
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
        if lap9 is not None:
            # paths 7b and 8 run the racestep, path 9 the megastep: their
            # launches join the records, their numbers the records' paths
            b7b, b8 = bounds["racestep_kernel n12 B=1 oval"], bounds["racestep_kernel n12 per-lane"]
            b9 = bounds["megastep_kernel pacejka n10"]
            race_rec["launches"] += race7b["launches"]["racestep"] + learn8["launches"]["racestep"]
            race_rec["paths"]["race-loop-learn"] = {
                "launches": race7b["launches"]["racestep"], "ms": race7b["ms"], "device_ms": race12[1]["device_ms"],
                "max_abs_err": race12[1]["max_abs_err"], "plain_ms": race12[1]["plain_ms"],
                "bound_ms": b7b[0], "bound_by": b7b[1]}
            race_rec["paths"]["race-learn"] = {
                "launches": learn8["launches"]["racestep"], "ms": learn8["ms"], "device_ms": learn8["device_ms"],
                "max_abs_err": learn8["err"]["fixed"], "max_abs_err_path_config": learn8["err"]["path config"],
                "plain_ms": learn8["plain_ms"], "bound_ms": b8[0], "bound_by": b8[1]}
            mega_rec["launches"] += lap9["launches"]["megastep"]
            mega_rec["paths"] = {
                "main": {"launches": launches["megastep"], "ms": mega_ms, "device_ms": mega_dev_ms},
                "lap-learn": {"launches": lap9["launches"]["megastep"], "ms": lap9["ms"],
                              "device_ms": lap["device_ms"], "device_ms_per_step": lap9["device_ms_step"],
                              "max_abs_err": lap["fixed"], "max_abs_err_path_config": lap["path config"],
                              "plain_ms": lap["plain_ms"], "bound_ms": b9[0], "bound_by": b9[1]}}
        mega_rec["eyb"] = {"max_abs_err": mega_eyb["fixed"], "device_ms": mega_eyb["dev_ms"],
                           "box_device_ms": mega_eyb["box_dev_ms"],
                           "bound_ms": bounds["megastep_kernel+eyb"][0]}
    if par is not None:
        # the parallel layer's paths: their launches join the records,
        # their numbers the records' paths
        rec = {k["name"]: k for k in kernels}
        path = lambda run, **kw: {"launches": sum(run["launches"].values()), "ms": run["ms"], **kw}
        b5f, b5m, bg = bounds["fused_kernel config5"], bounds["megastep_kernel config5"], bounds["fused_kernel global"]
        # the kernel-vs-plain check at the path's shapes: its error, one
        # kernel call's ms (CUDA events) and the plain version's
        held = lambda run, ms_key: {"max_abs_err": run["held"]["max_abs_err"], "kernel_ms": run["held"][ms_key],
                                    "plain_ms": run["held"]["plain_ms"]}
        fused_paths = {
            "config5": path(par["config5"], solves_per_s=par["config5"]["solves_per_s"],
                            peak_bytes=par["config5"]["peak_bytes"], bound_ms=b5f[0], bound_by=b5f[1],
                            **held(par["config5"], "solve_ms")),
            "config5-chunk": path(par["config5-chunk"], peak_bytes=par["config5-chunk"]["peak_bytes"],
                                  bound_ms=b5f[0], bound_by=b5f[1]),
            "ckpt": path(par["ckpt"], bound_ms=bounds["fused_kernel"][0], bound_by=bounds["fused_kernel"][1]),
            "global": path(par["global"], bound_ms=bg[0], bound_by=bg[1], **held(par["global"], "solve_ms"))}
        rec["fused_kernel"].setdefault("paths", {}).update(fused_paths)
        rec["megastep_kernel"].setdefault("paths", {})["config5-mega"] = path(
            par["config5-mega"], solves_per_s=par["config5-mega"]["solves_per_s"],
            peak_bytes=par["config5-mega"]["peak_bytes"], bound_ms=b5m[0], bound_by=b5m[1],
            **held(par["config5-mega"], "step_ms"))
        rec["racestep_kernel"].setdefault("paths", {})["sharded-race"] = path(par["sharded-race"])
        rec["admm_kernel"].setdefault("paths", {})["sharded-step"] = path(par["sharded-step"])
        for name, runs in (("fused_kernel", ("config5", "config5-chunk", "ckpt", "global")),
                           ("megastep_kernel", ("config5-mega",)), ("racestep_kernel", ("sharded-race",)),
                           ("admm_kernel", ("sharded-step",))):
            rec[name]["launches"] += sum(sum(par[r]["launches"].values()) for r in runs)
        dist.destroy_process_group()
    if pipe is not None:
        # the last slice's paths: the fused kernel's launches and numbers at
        # B=1 (each one's events ms, device ms and check against plain from
        # the path's own carry); the [utils] launches of the megastep and
        # of the kinematic fused kernel
        rec = {k["name"]: k for k in kernels}

        def b1(key, held, **kw):
            b_ms, b_by = bounds[key]
            return {"ms": held["solve_ms"], "device_ms": held["device_ms"], "max_abs_err": held["max_abs_err"],
                    "plain_ms": held["plain_ms"], "bound_ms": b_ms, "bound_by": b_by, **kw}

        n_pipe, n_rt = sum(pipe["launches"].values()), rt["lockstep"]["launches"]["fused"] + rt["ekf"]["launches"]["fused"]
        paths = rec["fused_kernel"].setdefault("paths", {})
        paths["pipelined"] = b1("fused_kernel pipelined", pipe["held"], launches=n_pipe, runs=pipe["launches"],
                                max_abs_err_60=pipe["held_60"]["max_abs_err"],
                                wall_serial_s=pipe["wall_serial_s"], wall_pipelined_s=pipe["wall_pipelined_s"],
                                predicted_s=pipe["predicted_s"], overlap_share=pipe["overlap_share"])
        paths["realtime"] = {"launches": n_rt, "runs": {
            tag: b1(f"fused_kernel realtime-{tag}", rt[tag]["held"], launches=rt[tag]["launches"]["fused"],
                    solve_p50_ms=rt[tag]["p50_ms"], solve_p99_ms=rt[tag]["p99_ms"], missed=rt[tag]["missed"])
            for tag in ("lockstep", "ekf")}}
        rec["fused_kernel"]["launches"] += n_pipe + n_rt
        rec["megastep_kernel"].setdefault("paths", {})["utils"] = {
            "launches": utl["launches"]["megastep"], "timed_ms": utl["timed_ms"], "events_ms": utl["events_ms"],
            "trace_process_launches": utl["trace_launches"]}
        rec["megastep_kernel"]["launches"] += utl["launches"]["megastep"]
        rec["fused_kernel_kinematic"].setdefault("paths", {})["utils"] = {"launches": utl["launches"]["fused"]}
        rec["fused_kernel_kinematic"]["launches"] += utl["launches"]["fused"]
    log(f"[total] chip_smoke.py wall {time.perf_counter() - t_script:.1f} s, the kernels' build included")
    if mega_cache is not None:
        # the cached instantiation's path figures beside its record's
        next(k for k in kernels if k["name"] == "megastep_kernel cached").update(
            {key: mega_cache[key] for key in ("reuse", "kinematic_max_abs_err", "drift_margin", "du_median",
                                             "du_p95", "du_max", "split_device_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def trace_megastep_child(logdir):
    """``python3 chip_smoke.py --trace-megastep <dir>``, started by [utils]:
    one megastep launch at cell 1's shape under ``utils.trace_to`` in a
    fresh process (the kernel library is the one the parent built); prints
    the trace's kernel names as one JSON line."""
    import torch

    sys.path.insert(0, HERE)
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, SolverConfig, VehicleParams
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.megastep_kernel import megastep, megastep_init, megastep_params
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import racetrack
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.utils import trace_to

    p, cfg = VehicleParams(), MPCConfig(N=N_MAIN, model="dynamic")
    scfg = SolverConfig(max_iter=20, rho_interval=0, early_exit=True, check_termination=2)
    track = racetrack()
    scen = make_scenario_grid(p, cfg, n_ey=64, n_mu=B_MAIN // 64, vx0=1.5)
    prm = megastep_params(scen.params, B_MAIN)
    car, ref = megastep_init(scen.params, cfg, track, scen.x0), constant_refs(cfg, 1.8)
    megastep(cfg, scfg, track, prm, ref, car, n_sub=4)
    torch.cuda.synchronize()
    with trace_to(logdir) as tr:
        megastep(cfg, scfg, track, prm, ref, car, n_sub=4)
    with open(tr.path) as f:
        names = sorted({e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"})
    print(json.dumps({"kernels": names, "launches": megastep.launches}), flush=True)


def two_cards():
    """``python3 chip_smoke.py --two-cards``, on a host with two cards or
    more: [pipelined]'s scenario with the planner on the second card (the
    default placement there) against the same loop with the planner on a
    second stream of the tracker's card. Every log field and planned span
    must be bitwise equal, every plan after the first must be made on the
    second card, and the tracker must run on the fused kernel."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        fail("--two-cards needs two CUDA devices")
    sys.path.insert(0, HERE)
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import MPCConfig, MPPConfig, SolverConfig, VehicleParams
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops import _cuda
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.ops.fused_kernel import fused_mpc_solve
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.planner import online as online_mod, pipelined_replanning_loop
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track

    card = gpu_name_power()
    log(f"[two-cards] {torch.cuda.device_count()} x {card}")
    _cuda.library()
    oval = oval_track()
    args = (VehicleParams(), MPCConfig(N=16, model="dynamic"),
            SolverConfig(max_iter=PIPE_ITERS, rho_interval=0, backend="fused"), MPPConfig(H=PIPE_H, n_sqp=2), oval,
            torch.tensor([1.0, 0.0, 0.0, 0.0, 0.0, 0.0], device="cuda:0"), T_PIPE)
    blk = np.array([[4.0, 5.0, -0.4, 0.1]], np.float32)
    orig_plan, plan_devs = online_mod.plan_mpp, []

    def recording(p, pcfg, track, **k):
        plan_devs.append(str(track.kappa.device))
        return orig_plan(p, pcfg, track, **k)

    runs = {}
    online_mod.plan_mpp = recording
    try:
        for tag, planner_device in (("one card", "cuda:0"), ("two cards", None)):
            plan_devs.clear()
            fused_mpc_solve.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pipelined_replanning_loop(*args, replan_every=REPLAN_EVERY, planner_device=planner_device,
                                            obstacles_fn=lambda t: blk if t >= REPLAN_EVERY else None)
            torch.cuda.synchronize()
            runs[tag] = {"res": res, "plans_on": list(plan_devs), "wall_s": time.perf_counter() - t0,
                         "launches": fused_mpc_solve.launches}
    finally:
        online_mod.plan_mpp = orig_plan
    one, two = runs["one card"]["res"], runs["two cards"]["res"]
    L = float(oval.length)
    X = two.log.X.cpu().numpy()
    s_mod = X[:, 4] % L
    mask = (np.arange(X.shape[0]) > 80) & (s_mod > 4.3) & (s_mod < 4.7)
    out = {"plans_on": {k: r["plans_on"] for k, r in runs.items()},
           "wall_s": {k: r["wall_s"] for k, r in runs.items()},
           "launches": {k: r["launches"] for k, r in runs.items()},
           "bitwise": all(torch.equal(a, b) for a, b in zip(one.log, two.log)),
           "max_dx": (one.log.X - two.log.X).abs().max().item(),
           "spans_equal": bool(np.array_equal(one.plan_progress, two.plan_progress)),
           "replans": two.replan_steps.tolist(), "s_end": float(X[-1, 4]),
           "converged": two.log.converged.float().mean().item(),
           "ey_past_block": float(X[mask, 5].min()) if mask.any() else float("nan")}
    log(f"[two-cards] {json.dumps(out)} ({card})")
    check(out["plans_on"]["two cards"] == ["cuda:1"] * (T_PIPE // REPLAN_EVERY),
          "[two-cards] the plans were not made on the second card")
    check(all(n == T_PIPE for n in out["launches"].values()), f"[two-cards] fused launches {out['launches']}")
    check(out["bitwise"] and out["spans_equal"], f"[two-cards] the placements differ: max |dX| {out['max_dx']:.3e}")
    check(out["replans"] == list(range(0, T_PIPE, REPLAN_EVERY)), f"[two-cards] replan steps {out['replans']}")
    check(out["s_end"] > 1.5 * L and out["converged"] > 0.85 and out["ey_past_block"] > 0.1,
          "[two-cards] the JAX test's checks failed")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--trace-megastep"]:
        trace_megastep_child(sys.argv[2])
    elif sys.argv[1:2] == ["--two-cards"]:
        two_cards()
    else:
        main()
