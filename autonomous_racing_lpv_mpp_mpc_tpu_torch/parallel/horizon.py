"""Horizon-dim parallelism: stage evaluation and the solve sharded (the JAX
package's ``parallel/horizon.py``).

The MPC horizon is this domain's sequence dim. Each rank along the mesh's
``horizon`` dim

1. evaluates only its chunk of the N quasi-LPV stage linearizations and
   their discretizations;
2. builds only its chunk of the cost and bound rows (``build_boxqp`` /
   ``tracker_bounds`` semantics, row by row);
3. runs its share of the distributed Riccati factorization
   (``riccati_dist.py``) and of every ADMM iteration (``admm_dist.py``).

The only replicated O(N) piece is the initial scheduling rollout, a
sequential nonlinear Euler recursion of O(N nx). The scenario dim composes
with it: each rank holds its scenario shard, and each scenario's horizon is
split over the ranks of its horizon group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.config import MPCConfig, SolverConfig, VehicleParams, broadcast_params
from ..engine.assembly import (
    N_CON, _s_index, augment_dynamics, constraint_rows, initial_schedule, scheduled_stages, speed_cap_at,
)
from ..models import model_nx
from ..models.dynamics import NU
from ..solver.riccati import LQRCost, LQRDynamics
from ..track.track import Track
from .admm_dist import ShardedBoxQP, admm_solve_horizon_sharded
from .collectives import all_gather
from .mesh import HORIZON_AXIS
from .scenarios import ScenarioBatch


def _sharded_qp_for(p: VehicleParams, cfg: MPCConfig, track: Track, x0: torch.Tensor, u0: torch.Tensor,
                    x_ref: torch.Tensor, n_h: int, hidx: int):
    """The :class:`ShardedBoxQP` of horizon rank ``hidx`` of ``n_h`` for the
    lanes x0 (B, nx), u0 (B, nu): stage tensors, cost rows and bounds only
    for the rank's window of stages [lo, lo + Nc]. Returns (qp, U_sched)."""
    N = cfg.N
    chunk = N // n_h
    kw = dict(dtype=torch.float32, device=x0.device)
    inf = float("inf")
    first, last = hidx == 0, hidx == n_h - 1
    lead = x0.shape[:-1]

    X_sched, U_sched = initial_schedule(p, cfg, track, x0, u0)
    lo = hidx * chunk
    Xc = X_sched[..., lo:lo + chunk + 1, :]
    Uc = U_sched[..., lo:lo + chunk, :]
    Aa, Ba, ca = augment_dynamics(*scheduled_stages(p, cfg, track, Xc, Uc))

    nx = model_nx(cfg.model)
    na = nx + NU
    # chunk-local cost rows; the boundary row Nc is live only on the last rank
    w = cfg.weights
    Qd = torch.tensor(w.q, **kw)[:nx]
    Rd = torch.diag(torch.tensor(w.r, **kw))
    dR = torch.diag(torch.tensor(w.dr, **kw))
    Q1 = torch.zeros((na, na), **kw)
    Q1[:nx, :nx] = torch.diag(Qd)
    Q_stage = Q1.clone()
    Q_stage[nx:, nx:] = dR
    Q = Q_stage.expand(lead + (chunk + 1, na, na)).clone()
    Q[..., chunk, :, :] = Q1 if last else 0.0
    R = (Rd + dR).expand(lead + (chunk, NU, NU)).clone()
    M_stage = torch.zeros((na, NU), **kw)
    M_stage[nx:, :] = -dR
    M = M_stage.expand(lead + (chunk, na, NU)).clone()
    rlin = torch.zeros(lead + (chunk, NU), **kw)

    # chunk-local bounds (tracker_bounds semantics)
    b = cfg.bounds
    lo_row = (b.vx_min, -b.ey_max, -b.delta_max, b.a_min, -b.ddelta_max, -b.da_max)
    hi_row = (b.vx_max, b.ey_max, b.delta_max, b.a_max, b.ddelta_max, b.da_max)
    lb = torch.tensor(lo_row, **kw).expand(lead + (chunk + 1, N_CON)).clone()
    ub = torch.tensor(hi_row, **kw).expand(lead + (chunk + 1, N_CON)).clone()
    if cfg.kappa_speed_cap:
        pb = broadcast_params(p, Xc.dim() - 1)
        ub[..., 0] = speed_cap_at(pb, track, Xc[..., _s_index(cfg.model)], b.vx_min, b.vx_max, cfg.a_lat_frac)
    if first:       # global stage 0: the state rows are off (x0 is fixed)
        lb[..., 0, :2] = -inf
        ub[..., 0, :2] = inf
    # the boundary row: the terminal stage on the last rank (no u_N: input
    # and rate rows off), wholly neutral on the others (the next rank owns it)
    lb[..., chunk, 2:] = -inf
    ub[..., chunk, 2:] = inf
    if not last:
        lb[..., chunk, :2] = -inf
        ub[..., chunk, :2] = inf

    # chunk-local linear cost, the vx reference clamped to the local friction cap
    xr = x_ref.to(**kw)[..., lo:lo + chunk + 1, :].expand(lead + (chunk + 1, nx)).clone()
    xr[..., 0] = torch.minimum(xr[..., 0], ub[..., 0])
    qlin = torch.zeros(lead + (chunk + 1, na), **kw)
    qlin[..., :nx] = -(xr * Qd)
    if not last:
        qlin[..., chunk, :] = 0.0

    Dx, Du = constraint_rows(cfg.model, device=x0.device)
    soft = torch.full((N_CON,), inf, **kw)
    soft[1] = b.ey_soft
    qp = ShardedBoxQP(dyn=LQRDynamics(Aa, Ba, ca), cost=LQRCost(Q, qlin, R, rlin, M),
                      Dx=Dx, Du=Du, lb=lb, ub=ub, x0=torch.cat([x0, u0], dim=-1), soft=soft)
    return qp, U_sched


def horizon_sharded_solve(mesh: DeviceMesh, scen: ScenarioBatch, cfg: MPCConfig, scfg: SolverConfig,
                          track: Track, x_ref: torch.Tensor):
    """One batched MPC solve on the 2-D (scenarios x horizon) mesh, from
    rest (u0 = 0, the initial schedule): ``scen`` is this rank's scenario
    shard, and each of its solves is split over the rank's horizon group.
    ``cfg.N`` must divide by the horizon dim's size. Returns (U (b, N, nu),
    converged (b,)) on every rank of the horizon group, the chunks
    all-gathered once at the end."""
    group = mesh.get_group(HORIZON_AXIS)
    n_h = dist.get_world_size(group)
    if cfg.N % n_h:
        raise ValueError(f"N={cfg.N} must divide by the horizon dim's {n_h} ranks")
    u0 = torch.zeros(scen.x0.shape[:-1] + (NU,), dtype=torch.float32, device=scen.x0.device)
    qp, _ = _sharded_qp_for(scen.params, cfg, track, scen.x0, u0, x_ref, n_h, dist.get_rank(group))
    sol = admm_solve_horizon_sharded(qp, scfg, group)
    return all_gather(sol.U, group, axis=-2, tiled=True), sol.converged
