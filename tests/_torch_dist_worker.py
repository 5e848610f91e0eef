"""Rank bodies for the port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_checkpoint.py), spawned on the CPU with gloo.

Each body is ``fn(rank, world, store, out_dir, *args)``: it joins a
``world``-rank group through the FileStore at ``store`` (a path under the
test's tmp_path, so that no port is taken and runs under xdist do not
collide), runs its part and writes what the parent test compares to
``out_dir/rank<r>.pt``. This module imports torch and the port only, never
JAX: the parent holds the results against the JAX package.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from autonomous_racing_lpv_mpp_mpc_tpu_torch.core import (
    MPCConfig, MPCWeights, SolverConfig, VehicleParams,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.loop import constant_refs
from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import (
    host_local_to_global, make_mesh, multihost_init, scenario_sharding,
)
from autonomous_racing_lpv_mpp_mpc_tpu_torch.track import oval_track

CPU = "cpu"
# tests/test_parallel.py's sweep
KIN = MPCConfig(N=8, model="kinematic", weights=MPCWeights.for_model("kinematic"))
KIN_SCFG = SolverConfig(max_iter=40)
# tests/test_multiprocess.py's checkpointed sweep
CK_CFG = MPCConfig(N=8, model="dynamic")
CK_SCFG = SolverConfig(max_iter=15, rho_interval=0)


def start(fn, world: int, *args):
    """Start ``fn(rank, world, *args)`` in ``world`` spawned processes;
    :func:`wait` for them."""
    return mp.start_processes(fn, args=(world,) + args, nprocs=world, join=False, start_method="spawn")


def wait(ctx, timeout: float = 300.0) -> None:
    """Wait for every rank of ``ctx``; a rank that failed raises here, and
    ranks still running after ``timeout`` seconds are terminated and raise
    ``TimeoutError``."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"ranks still running after {timeout} s")


def spawn(fn, world: int, *args, timeout: float = 300.0) -> None:
    """:func:`start` then :func:`wait`."""
    wait(start(fn, world, *args), timeout)


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    multihost_init(init_method=f"file://{store}", world_size=world, rank=rank, device=CPU)


def _save(out_dir: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out_dir, f"rank{rank}.pt"))


def riccati_inputs(N: int = 16, na: int = 4, nu: int = 2):
    """The random LQR of tests/test_parallel.py::
    test_horizon_sharded_riccati_matches_single_device, as numpy arrays."""
    rng = np.random.default_rng(0)
    A = np.stack([np.eye(na) + 0.05 * rng.standard_normal((na, na)) for _ in range(N)])
    B = 0.2 * rng.standard_normal((N, na, nu))
    c = 0.05 * rng.standard_normal((N, na))
    Q = np.stack([np.diag(rng.uniform(0.2, 2.0, na)) for _ in range(N + 1)])
    R = np.stack([np.diag(rng.uniform(0.3, 1.5, nu)) for _ in range(N)])
    M = 0.02 * rng.standard_normal((N, na, nu))
    f32 = lambda a: a.astype(np.float32)
    return dict(A=f32(A), B=f32(B), c=f32(c), Q=f32(Q), q=np.zeros((N + 1, na), np.float32), R=f32(R),
                r=np.zeros((N, nu), np.float32), M=f32(M))


ADMM_X0 = np.array([1.2, 0.0, 0.0, 0.0, 0.3, 0.05], np.float32)
ADMM_CFG = MPCConfig(N=16, model="dynamic")
ADMM_SCFG = SolverConfig(max_iter=40, rho_interval=10)


def admm_qp():
    """tests/test_horizon_dist.py's N=16 QP, assembled by the port."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.engine import build_boxqp, initial_schedule

    track = oval_track(device=CPU)
    x0 = torch.tensor(ADMM_X0)[None]
    u0 = torch.zeros((1, 2))
    X_s, U_s = initial_schedule(VehicleParams(), ADMM_CFG, track, x0, u0)
    return build_boxqp(VehicleParams(), ADMM_CFG, track, x0, u0, X_s, U_s,
                       constant_refs(ADMM_CFG, 1.5, device=CPU))


def closed_loop_rank(rank, world, store, out_dir):
    """tests/test_parallel.py's B=8 kinematic sweep, T=30, over ``world``
    scenario ranks: the local log, the gathered global X and the metrics."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid, sharded_closed_loop

    _join(rank, world, store)
    mesh = make_mesh(device=CPU)
    scen = make_scenario_grid(VehicleParams(), KIN, n_ey=4, n_mu=2, vx0=1.0, device=CPU)
    log, m = sharded_closed_loop(mesh, scenario_sharding(mesh, scen), KIN, KIN_SCFG, oval_track(device=CPU),
                                 constant_refs(KIN, 1.2, device=CPU), T=30)
    _save(out_dir, rank, {"X_local": log.X, "X": host_local_to_global(mesh, log.X), "metrics": tuple(m)})
    dist.destroy_process_group()


def horizon_rank(rank, world, store, out_dir):
    """The horizon-sharded Riccati factorization of :func:`riccati_inputs`
    and the horizon-sharded ADMM on :func:`admm_qp`, over ``world`` horizon
    ranks; the local chunks gathered along the stages."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import (
        admm_solve_horizon_sharded, riccati_factor_horizon_sharded, shard_boxqp,
    )
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.collectives import all_gather
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.solver import LQRCost, LQRDynamics

    _join(rank, world, store)
    group = make_mesh(n_scenario=1, n_horizon=world, device=CPU).get_group("horizon")
    d = {k: torch.tensor(v) for k, v in riccati_inputs().items()}
    N = d["A"].shape[0]
    Nc = N // world
    lo = rank * Nc
    fac = riccati_factor_horizon_sharded(
        LQRDynamics(d["A"][lo:lo + Nc], d["B"][lo:lo + Nc], d["c"][lo:lo + Nc]),
        LQRCost(d["Q"][lo:lo + Nc + 1], d["q"][lo:lo + Nc + 1], d["R"][lo:lo + Nc], d["r"][lo:lo + Nc],
                d["M"][lo:lo + Nc]), group)
    sol = admm_solve_horizon_sharded(shard_boxqp(admm_qp(), group, world), ADMM_SCFG, group)
    _save(out_dir, rank, {"K": all_gather(fac.K, group, axis=0, tiled=True),
                          "Vc": all_gather(fac.Vc, group, axis=0, tiled=True),
                          "U": all_gather(sol.U, group, axis=-2, tiled=True)[0],
                          "X": all_gather(sol.X[..., :-1, :], group, axis=-2, tiled=True)[0],
                          "converged": sol.converged[0], "rho": sol.rho[0],
                          "r_prim": sol.r_prim[0], "r_dual": sol.r_dual[0]})
    dist.destroy_process_group()


def horizon_2d_rank(rank, world, store, out_dir):
    """``horizon_sharded_solve`` on a 2 x 2 (scenarios x horizon) mesh:
    tests/test_parallel.py::test_horizon_sharded_solve_matches_plain's
    four lanes, each solve split over two horizon ranks."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.horizon import horizon_sharded_solve

    _join(rank, world, store)
    mesh = make_mesh(n_scenario=2, n_horizon=2, device=CPU)
    cfg = MPCConfig(N=8, model="dynamic")
    scen = make_scenario_grid(VehicleParams(), cfg, n_ey=4, n_mu=1, vx0=1.2, device=CPU)
    U, conv = horizon_sharded_solve(mesh, scenario_sharding(mesh, scen), cfg, SolverConfig(max_iter=30),
                                    oval_track(device=CPU), constant_refs(cfg, 1.5, device=CPU))
    _save(out_dir, rank, {"U": host_local_to_global(mesh, U), "converged": host_local_to_global(mesh, conv)})
    dist.destroy_process_group()


def ckpt_rank(rank, world, store, out_dir, ckpt_dir, T, save_every):
    """tests/_mp_ckpt_worker.py's checkpointed sweep (the 8-lane dynamic
    grid on the oval) over ``world`` scenario ranks: (steps run, metrics)."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel import make_scenario_grid
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.parallel.scenarios import checkpointed_sweep

    _join(rank, world, store)
    mesh = make_mesh(device=CPU)
    scen = make_scenario_grid(VehicleParams(), CK_CFG, n_ey=8, n_mu=1, vx0=1.0, device=CPU)
    m, steps = checkpointed_sweep(mesh, scenario_sharding(mesh, scen), CK_CFG, CK_SCFG, oval_track(device=CPU),
                                  constant_refs(CK_CFG, 1.4, device=CPU), T, checkpoint_dir=ckpt_dir,
                                  save_every=save_every)
    _save(out_dir, rank, {"steps": steps, "metrics": tuple(m)})
    dist.destroy_process_group()


def config5_rank(rank, world, store, out_dir):
    """tests/_mp_eff_worker.py: the config5 preset under ``world`` ranks,
    per_device=8, T=6, seven interleaved leg pairs."""
    from autonomous_racing_lpv_mpp_mpc_tpu_torch.bench import run_preset

    _join(rank, world, store)
    _save(out_dir, rank, run_preset("config5", device=CPU, per_device=8, T=6, trials=7))
    dist.destroy_process_group()
