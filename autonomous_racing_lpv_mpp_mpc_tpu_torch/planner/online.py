"""Online receding-horizon replanning: planner and tracker at two rates (the
JAX package's ``planner/online.py``, serial form).

The obstacle-aware planner re-plans a receding horizon from the car's
current state every ``replan_every`` tracker steps, so obstacles that
appear mid-lap are avoided; the tracker follows the latest table. The host
drives the outer loop; each tracking segment is ``replan_every`` steps of
``mpc_step`` + ``plant_step`` on one car.

The pipelined form (the planner on a second device, concurrent with the
tracker) waits for the parallel layer.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import MPCConfig, MPPConfig, SolverConfig, VehicleParams
from ..track.track import Track
from .mpp import plan_mpp
from .opponents import pad_blocks
from .reftable import RefTable


class ReplanLog(NamedTuple):
    log: NamedTuple               # ClosedLoopLog over the T steps, (T, ...)
    replan_steps: np.ndarray      # step indices where replanning happened
    plan_progress: np.ndarray     # planned span per replan [m]


def _track_segment(p, cfg: MPCConfig, scfg: SolverConfig, track: Track, T_seg: int, sim_tire):
    """``run(x0, carry, table, obstacles=None)``: T_seg closed-loop steps of
    one car, returning the final state and carry and the segment's log."""
    # (imported here: loop.mpc imports planner.reftable, so a module-level
    # import would make the planner package circular)
    from ..loop.closed_loop import ClosedLoopLog, plant_step
    from ..loop.mpc import mpc_step

    def run(x0, carry, table: RefTable, obstacles=None):
        x, outs = x0, []
        for _ in range(T_seg):
            u, carry, diag = mpc_step(p, cfg, scfg, track, x, table, carry, obstacles=obstacles)
            x = plant_step(p, cfg, track, x, u, n_sub=10, sim_tire=sim_tire)
            outs.append((x, u, diag.converged, diag.iters, diag.r_prim, diag.r_dual,
                         diag.certified_infeasible))
        return x, carry, ClosedLoopLog(*(torch.stack(col) for col in zip(*outs)))

    return run


def replanning_loop(
    p: VehicleParams,
    cfg: MPCConfig,
    scfg: SolverConfig,
    pcfg: MPPConfig,
    track: Track,
    x0: torch.Tensor,
    T: int,
    replan_every: int = 60,
    obstacles_fn: Optional[Callable[[int], Optional[np.ndarray]]] = None,
    sim_tire: Optional[str] = None,
    plan_scfg: Optional[SolverConfig] = None,
    max_obstacle_rows: int = 8,
) -> ReplanLog:
    """Run T tracker steps from x0 (nx,), re-planning every ``replan_every``
    steps.

    ``obstacles_fn(step)`` returns the (n_obs, 4) blocks visible at that
    step (or None); they may appear and move between replans. The blocks
    reach both the planner (corridor-shifted reference) and the tracker QP
    (per-stage e_y corridor), padded to ``max_obstacle_rows``, so avoidance
    holds even when the tracker lags the planned line.
    """
    from ..loop.mpc import mpc_init

    if cfg.model != pcfg.model:
        raise ValueError(f"tracker model {cfg.model!r} and planner model {pcfg.model!r} differ")
    segment = _track_segment(p, cfg, scfg, track, replan_every, sim_tire)
    carry = mpc_init(p, cfg, track, x0)
    x = x0
    logs: List = []
    replan_steps, spans = [], []
    t = 0
    while t < T:
        obs = obstacles_fn(t) if obstacles_fn is not None else None
        if obs is not None:
            obs = torch.as_tensor(pad_blocks(obs, max_obstacle_rows), device=x.device)
        table, diag = plan_mpp(p, pcfg, track, scfg=plan_scfg, obstacles=obs, x0_state=x)
        replan_steps.append(t)
        spans.append(float(diag.progress))
        x, carry, log = segment(x, carry, table, obs)
        logs.append(log)
        t += replan_every
    cat = type(logs[0])(*(torch.cat(cols, dim=0) for cols in zip(*logs)))
    return ReplanLog(log=cat, replan_steps=np.asarray(replan_steps), plan_progress=np.asarray(spans))
