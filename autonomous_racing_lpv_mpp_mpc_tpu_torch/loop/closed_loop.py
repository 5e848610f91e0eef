"""Closed loop: estimate -> solve -> apply -> simulate (the JAX package's
``loop/closed_loop.py``). The plant is integrated at a fine Euler sub-step
and may use a different tire model than the controller's LPV."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import MPCConfig, SolverConfig, VehicleParams, broadcast_params
from ..models import f_model
from ..track.track import Track, curvature_at
from ..utils import profiling
from .mpc import MPCCarry, mpc_init, mpc_step_batched


class ClosedLoopLog(NamedTuple):
    X: torch.Tensor          # (T, B, nx) plant states after each step
    U: torch.Tensor          # (T, B, nu) applied controls
    converged: torch.Tensor  # (T, B)
    iters: torch.Tensor      # (T, B)
    r_prim: torch.Tensor     # (T, B)
    r_dual: torch.Tensor     # (T, B)
    certified_infeasible: torch.Tensor   # (T, B) the Farkas certificate (MPCDiag)


class ClosedLoopLogPred(NamedTuple):
    """ClosedLoopLog and the tracker's predicted trajectory at each step
    (for predicted-against-closed-loop plots)."""

    X: torch.Tensor
    U: torch.Tensor
    converged: torch.Tensor
    iters: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    certified_infeasible: torch.Tensor
    X_pred: torch.Tensor     # (T, B, N+1, nx) the prediction made at each step


def plant_step(p: VehicleParams, cfg: MPCConfig, track: Track, x: torch.Tensor,
               u: torch.Tensor, n_sub: int = 10, sim_tire: Optional[str] = None,
               sim_model: Optional[str] = None):
    """Integrate the nonlinear plant for one control period; x (B, nx).
    While a profiler records, in the span ``plant.step``."""
    with profiling.span("plant.step", profiling.tracing()):
        tire = sim_tire or cfg.tire
        model = sim_model or cfg.model
        h = cfg.dt / n_sub
        s_idx = 4 if model == "dynamic" else 2
        pb = broadcast_params(p, x.dim() - 1)
        for _ in range(n_sub):
            kap = curvature_at(track, x[..., s_idx])
            x = x + h * f_model(pb, x, u, kap, model, tire)
        return x


def closed_loop(p: VehicleParams, cfg: MPCConfig, scfg: SolverConfig, track: Track,
                x0: torch.Tensor, x_ref: torch.Tensor, T: int, n_sub: int = 10,
                sim_tire: Optional[str] = None, carry0: Optional[MPCCarry] = None,
                log_predictions: bool = False, obstacles=None) -> ClosedLoopLog:
    """Run T control steps for a batch x0 (B, nx), or for one car x0 (nx,)
    (the JAX package's form: its carry and log have no batch dim); returns
    stacked logs. ``log_predictions=True`` also records each step's
    predicted trajectory (:class:`ClosedLoopLogPred`). ``obstacles`` is a
    static (n_obs, 4) corridor-block array
    (``engine.assembly.corridor_from_blocks``) applied to every step's
    tracker bounds: parked obstacles."""
    if x0.dim() == 1:
        c0 = None if carry0 is None else MPCCarry(*(t.unsqueeze(0) for t in carry0))
        log = closed_loop(p, cfg, scfg, track, x0[None], x_ref, T, n_sub, sim_tire, c0,
                          log_predictions, obstacles)
        return type(log)(*(t[:, 0] for t in log))
    carry = carry0 if carry0 is not None else mpc_init(p, cfg, track, x0)
    x = x0
    outs = []
    for _ in range(T):
        u, carry, diag = mpc_step_batched(p, cfg, scfg, track, x, x_ref, carry, obstacles)
        x = plant_step(p, cfg, track, x, u, n_sub=n_sub, sim_tire=sim_tire)
        out = (x, u, diag.converged, diag.iters, diag.r_prim, diag.r_dual, diag.certified_infeasible)
        outs.append(out + (carry.X_pred,) if log_predictions else out)
    cols = (torch.stack(col) for col in zip(*outs))
    return ClosedLoopLogPred(*cols) if log_predictions else ClosedLoopLog(*cols)
